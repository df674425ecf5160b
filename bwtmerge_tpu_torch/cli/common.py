"""CLI helpers of the port: pattern verification on a torch device.

Pattern files, format checks and reporting are the JAX package's
(bwtmerge_tpu/cli/common.py); only verify_fmi changes, to count through
the port's batch_count.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from bwtmerge_tpu.cli.common import check_format, read_rows, report_totals
from bwtmerge_tpu.utils.metrics import in_megabytes

from ..models.fmi import FMI
from ..ops.rank_torch import batch_count

__all__ = ["check_format", "read_rows", "report_totals", "verify_fmi"]


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
