"""Timing, memory, and throughput observability.

Parity with the reference's readTimer/memoryUsage/printSize/printTime
(utils.h:204-216, utils.cpp:38-96) plus structured per-phase metrics so merge
throughput is reported in the same units (MB/s, Mbases/s) as the paper.
"""

from __future__ import annotations

import os
import resource
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator

MEGABYTE = 1024 * 1024
GIGABYTE = 1024 * MEGABYTE


def read_timer() -> float:
    """Seconds from an arbitrary time point (monotonic)."""
    return time.monotonic()


def memory_usage() -> int:
    """Peak RSS of this process in bytes (reference utils.cpp:86-96)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def in_megabytes(num_bytes: int) -> float:
    return num_bytes / float(MEGABYTE)


def in_gigabytes(num_bytes: int) -> float:
    return num_bytes / float(GIGABYTE)


def in_bpc(num_bytes: int, data_size: int) -> float:
    """Bits per character."""
    return 8.0 * num_bytes / data_size if data_size else 0.0


def print_size(header: str, num_bytes: int, data_size: int, out=sys.stdout) -> None:
    out.write(f"{header + ':':<18}{in_megabytes(num_bytes):.6g} MB "
              f"({in_bpc(num_bytes, data_size):.6g} bpc)\n")


def print_time(header: str, found: int, matches: int, num_bytes: int, seconds: float,
               out=sys.stdout) -> None:
    mbs = in_megabytes(num_bytes) / seconds if seconds > 0 else 0.0
    out.write(f"{header + ':':<18}Found {found} patterns with {matches} occ in "
              f"{seconds:.6g} seconds ({mbs:.6g} MB/s)\n")


@dataclass
class PhaseTimer:
    """Structured per-phase wall-clock metrics for the merge pipeline.

    Replaces the reference's VERBOSE_STATUS_INFO stderr tracing (SURVEY.md §5)
    with a queryable record: timer.phases -> {name: seconds}.
    """

    phases: Dict[str, float] = field(default_factory=dict)
    verbose: bool = False
    traces: int = 0

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = read_timer()
        try:
            yield
        finally:
            elapsed = read_timer() - start
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            if self.verbose:
                sys.stderr.write(f"bwt_merge: {name} finished in {elapsed:.3f} seconds\n")

    def total(self) -> float:
        return sum(self.phases.values())

    @contextmanager
    def device_trace(self, trace_dir: str | None,
                     device="cuda") -> Iterator[None]:
        """torch.profiler trace around a region (no-op when trace_dir is
        None): wall-clock phases stay in `phases`; the timeline of the
        region (operators, kernels, copies) is written as a Chrome trace,
        `trace_<pid>_<k>.json` under trace_dir, one file per region (open it
        in Perfetto or chrome://tracing).  A CUDA `device` adds the card's
        activities to the host's; on the CPU only the host's are recorded.
        """
        if not trace_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir,
                            f"trace_{os.getpid()}_{self.traces}.json")
        self.traces += 1
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(path)

    def report(self, num_bytes: int, out=sys.stderr) -> None:
        for name, seconds in self.phases.items():
            mbs = in_megabytes(num_bytes) / seconds if seconds > 0 else 0.0
            out.write(f"  {name:<24}{seconds:10.3f} s  ({mbs:10.2f} MB/s)\n")
