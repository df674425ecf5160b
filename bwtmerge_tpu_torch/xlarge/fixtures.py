"""The xlarge tier's cached fixtures: 102 Mbp pieces and a 714 Mbp base.

Port of the JAX tree's `scripts/build_xlarge_fixtures.py`, with its recipe:
a piece is M = 2,000,000 reads of L = 50 characters,
`np.random.default_rng(seed).integers(1, 5, size=M * L)`, built on the
device by models/build.build_from_reads in read order (no RLO) and written
as an SGA file with its `.reads4` read-text sidecar.  The base is piece 201
left-folded with pieces 202..207, one models/merge.merge_fmi at a time (the
walk over each piece's sidecar), every fold written as a native checkpoint
so that a killed build resumes from the largest one.  Pieces 208 and 209
are the inserts of the 3-way tier.

Every file is cached under one directory (`.smoke_cache/xl/` unless the
caller names another), its name holding the pieces' read count; a build
whose files exist is a no-op.  Each step built is recorded with its wall
seconds, its sampled peaks of host memory and, on a card, its peak device
memory.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

READS = 2_000_000           # reads a piece: 102 Mbp with the endmarkers
READ_LEN = 50
FIRST_SEED = 201            # the base's first piece
BASE_SEEDS = (202, 203, 204, 205, 206, 207)   # folded into it, in order
INSERT_SEEDS = (208, 209)   # the 3-way tier's inserts
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache() -> str:
    return os.path.join(ROOT, ".smoke_cache", "xl")


def piece_path(cache: str, seed: int, reads: int = READS) -> str:
    return os.path.join(cache, f"xl_piece_{seed}_{reads}.sga")


def base_path(cache: str, folds: int = len(BASE_SEEDS),
              reads: int = READS) -> str:
    """The base of `folds` folds (the full tier's has six)."""
    return os.path.join(cache, f"xl_base_{folds}_{reads}.native")


def checkpoint_path(cache: str, k: int, reads: int = READS) -> str:
    """The base build's checkpoint after its first k folds."""
    return os.path.join(cache, f"xl_fold_{k}_{reads}.native")


def piece_reads(seed: int, reads: int = READS):
    """A piece's reads as build_from_reads takes them: (flat int32 comp
    values 1..4, lengths int64)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(1, 5, size=reads * READ_LEN).astype(np.int32)
    return flat, np.full(reads, READ_LEN, np.int64)


def _rss() -> int:
    """Bytes of this process's resident set (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def _host_used() -> int:
    """Bytes of host memory in use by every process (MemTotal less
    MemAvailable)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024
    return info["MemTotal"] - info["MemAvailable"]


@contextlib.contextmanager
def measured(steps: Optional[list], name: str, device,
             sample_s: float = 0.5):
    """Record the block as a dict in `steps`: "s", its wall seconds; the
    peaks of samples taken every `sample_s`: "peak_rss_GB", this
    process's RSS, "peak_host_used_GB", the host memory in use by every
    process (a fold's chain stages included) less its use at the start;
    "peak_device_GB", its peak of device memory allocated (None on the
    CPU).  The dict is yielded so the block can add to it."""
    import threading

    import torch

    dev = torch.device(device)
    rec = {"step": name}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    start_used = _host_used()
    peak = {"rss": 0, "used": start_used}
    done = threading.Event()

    def sample():
        while True:
            peak["rss"] = max(peak["rss"], _rss())
            peak["used"] = max(peak["used"], _host_used())
            if done.wait(sample_s):
                return

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.monotonic()
    try:
        yield rec
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        done.set()
        sampler.join()
    rec["s"] = time.monotonic() - t0
    rec["peak_rss_GB"] = peak["rss"] / 1e9
    rec["peak_host_used_GB"] = (peak["used"] - start_used) / 1e9
    rec["peak_device_GB"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else None)
    if steps is not None:
        steps.append(rec)
    print(f"xlarge: {json.dumps(rec)}", file=sys.stderr, flush=True)


def build_piece(cache: str, seed: int, reads: int = READS, device="cuda",
                steps: Optional[list] = None) -> str:
    """One piece's SGA file and sidecar, built on `device`; cached.  The
    sidecar is written first and the SGA file renamed into place last, so
    a piece whose SGA file exists is whole."""
    from ..formats import write_bwt
    from ..formats.sidecar import sidecar_path, write_sidecar
    from ..models.build import alphabet_for, build_from_reads

    path = piece_path(cache, seed, reads)
    if os.path.exists(path):
        return path
    os.makedirs(cache, exist_ok=True)
    with measured(steps, f"piece {seed}", device) as rec:
        flat, lens = piece_reads(seed, reads)
        runs, _ = build_from_reads((flat, lens), rlo=False, backend="torch",
                                   device=device)
        want = np.bincount(flat, minlength=6)
        want[0] = reads
        if not np.array_equal(runs.counts(6), want):
            raise RuntimeError(f"piece {seed}: symbol counts "
                               f"{runs.counts(6)} of the build, {want} of "
                               f"the reads")
        write_sidecar(sidecar_path(path), lens.astype(np.uint32),
                      flat.astype(np.uint8))
        write_bwt(path + ".tmp", "sga", runs, alphabet_for(runs))
        os.replace(path + ".tmp", path)
        rec["bases"] = runs.size()
    return path


def _save_native(acc, path: str) -> None:
    """The accumulated base as a native file, in run chunks of 2^22."""
    from ..formats.streaming import write_bwt_stream

    def chunks():
        step = 1 << 22
        for s in range(0, acc.runs.syms.size, step):
            yield acc.runs.syms[s:s + step], acc.runs.lens[s:s + step]

    write_bwt_stream(path, "native", chunks(), acc.alpha)


def build_base(cache: str, reads: int = READS, device="cuda",
               base_seeds: Sequence[int] = BASE_SEEDS,
               steps: Optional[list] = None) -> str:
    """Piece FIRST_SEED left-folded with `base_seeds` by merge_fmi on
    `device`, resumed from the largest checkpoint; cached."""
    from ..formats import read_bwt
    from ..formats.sidecar import sidecar_path
    from ..models.fmi import FMI
    from ..models.merge import MergeConfig, merge_fmi

    folds = len(base_seeds)
    out = base_path(cache, folds, reads)
    if os.path.exists(out):
        return out
    cfg = MergeConfig(device=str(device), temp_dir=cache, search="auto")
    acc, start = None, 0
    for k in range(folds, 0, -1):
        if os.path.exists(checkpoint_path(cache, k, reads)):
            runs, _, alpha = read_bwt(checkpoint_path(cache, k, reads),
                                      "native")
            acc, start = FMI(runs=runs, alpha=alpha), k
            break
    if acc is None:
        p0 = build_piece(cache, FIRST_SEED, reads, device, steps)
        runs, _, alpha = read_bwt(p0, "sga")
        acc = FMI(runs=runs, alpha=alpha, creads_path=sidecar_path(p0))
    for k in range(start, folds):
        seed = base_seeds[k]
        p = build_piece(cache, seed, reads, device, steps)
        with measured(steps, f"fold +{seed}", device) as rec:
            runs, _, alpha = read_bwt(p, "sga")
            ins = FMI(runs=runs, alpha=alpha, creads_path=sidecar_path(p))
            acc = merge_fmi(acc, ins, cfg)
            del ins, runs
            _save_native(acc, checkpoint_path(cache, k + 1, reads))
            rec["bases"] = acc.size()
        if os.path.exists(checkpoint_path(cache, k, reads)):
            os.remove(checkpoint_path(cache, k, reads))
    os.replace(checkpoint_path(cache, folds, reads), out)
    return out


def build(cache: Optional[str] = None, reads: int = READS, device="cuda",
          base_seeds: Sequence[int] = BASE_SEEDS,
          insert_seeds: Sequence[int] = INSERT_SEEDS) -> List[dict]:
    """The base and the insert pieces; the steps built (none when every
    file was cached)."""
    from ..kernels import resolve_device

    device = resolve_device(device)
    cache = cache or default_cache()
    steps: List[dict] = []
    build_base(cache, reads, device, base_seeds, steps)
    for seed in insert_seeds:
        build_piece(cache, seed, reads, device, steps)
    return steps

