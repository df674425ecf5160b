"""Shared CLI helpers of the port: pattern files, format checks, pattern
verification on a torch device, reporting.

Port of bwtmerge_tpu/cli/common.py (the reference CLI plumbing,
bwt_merge.cpp:205-299, formats.cpp:449-479, utils.cpp:38-96); verify_fmi
counts through the port's batch_count.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np

from ..formats import FORMATS
from ..models.fmi import FMI
from ..ops.rank_torch import batch_count
from ..utils.metrics import in_gigabytes, in_megabytes, memory_usage


def read_rows(path: str, skip_empty: bool = True) -> List[str]:
    """Read pattern lines (reference readRows; bwt_merge.cpp:156)."""
    rows: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line or not skip_empty:
                rows.append(line)
    return rows


def check_format(tag: str, tool: str, kind: str) -> None:
    if tag not in FORMATS:
        print(f"{tool}: Invalid {kind} format: {tag}", file=sys.stderr)
        sys.exit(1)


def verify_fmi(fmi: FMI, role: str, patterns: List[str],
               results: np.ndarray, verbose: bool = True,
               device="cuda") -> None:
    """Count every pattern in `fmi` on `device` and ACCUMULATE the counts
    into `results` (reference verifyFMI, bwt_merge.cpp:263-285)."""
    if not patterns:
        return
    start = time.monotonic()
    counts = batch_count(fmi.device_index(device), patterns,
                         fmi.alpha.char2comp)
    results += counts
    seconds = time.monotonic() - start
    if verbose:
        total = sum(len(p) for p in patterns)
        rate = len(patterns) / seconds if seconds > 0 else float("inf")
        print(f"{role}: {len(patterns)} patterns, {int(counts.sum())} "
              f"occurrences ({seconds:.2f} s, {rate:.0f} patterns/s, "
              f"{in_megabytes(total) / max(seconds, 1e-9):.2f} MB/s)")


def report_totals(seconds: float, bytes_processed: int) -> None:
    print(f"Total time:       {seconds:.2f} seconds "
          f"({in_megabytes(bytes_processed) / max(seconds, 1e-9):.2f} MB/s)")
    print(f"Peak memory:      {in_gigabytes(memory_usage()):.3f} GB")
    print("")
