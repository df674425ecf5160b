"""The xlarge tier: one k-way fold of a 714 Mbp base and its inserts into a
native file, timed, with the pattern-count invariant checked outside the
measured window.

Port of the JAX tree's `bench_xlarge.py`.  Tiers:

    python -m bwtmerge_tpu_torch.xlarge.bench             # 3-way, 918 Mbp
    python -m bwtmerge_tpu_torch.xlarge.bench --pieces 9  # 10-way, 1.63 Gbp
    python -m bwtmerge_tpu_torch.xlarge.bench --pieces 27 # 28-way, 3.47 Gbp
    python -m bwtmerge_tpu_torch.xlarge.bench --big 6     # 7-way, 3.77 Gbp

`--pieces N` inserts N of the cached 102 Mbp pieces 209, 208, ..., 201,
cycling past nine (a file listed twice is a legal input: its reads twice).
`--big N` inserts the first N big pieces of big_pieces.py instead.
Missing fixtures are built first (fixtures.py, big_pieces.py; cached under
`.smoke_cache/xl/`), as set-up.

The measured window is the fold alone: models/kfold.merge_files_many(
paths, out, fmts, "native", MergeConfig(search="auto", verbose=True)).
Outside it, the output's size must equal the sum of the inputs', and the
counts of 4,096 read-derived 32-mers (default_rng(17), 2,048 columns of
the sidecars of pieces 209 and 208) in the output must equal their sums
over the inputs (the reference's -v gate).  An input or output within the
device layout is counted on the device (DeviceFMIndex.from_nibbles,
rank_torch.batch_count); a larger one by the host's block-sampled rank
(ops/rank_np.SparseRankIndex).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import big_pieces, fixtures
from .fixtures import READS, measured

BASELINE_MBP_S = 9.40        # the reference's published fold rate (BASELINE.md)
PIECE_CYCLE = (209, 208, 207, 206, 205, 204, 203, 202, 201)
PATTERN_SEED = 17
PATTERN_COLUMNS = 2048       # reads sampled from each source piece
PATTERN_LEN = 32
PATTERN_SOURCES = (209, 208)


def tier_inputs(cache: str, reads: int = READS, pieces: int = 2,
                big: int = 0, base_folds: int = len(fixtures.BASE_SEEDS),
                device="cuda", steps: Optional[list] = None
                ) -> Tuple[List[str], List[str]]:
    """The fold's (paths, formats): the base, then `big` big pieces or
    `pieces` 102 Mbp pieces; each built first where missing."""
    base = fixtures.build_base(cache, reads, device,
                               fixtures.BASE_SEEDS[:base_folds], steps)
    if big:
        names = dict(list(big_pieces.GROUPS.items())[:big])
        paths = big_pieces.build(cache, reads, device, names, steps)
        return [base] + paths, ["native"] * (big + 1)
    ids = [PIECE_CYCLE[i % len(PIECE_CYCLE)] for i in range(pieces)]
    paths = [fixtures.build_piece(cache, s, reads, device, steps) for s in ids]
    return [base] + paths, ["native"] + ["sga"] * pieces


def read_patterns(cache: str, reads: int = READS,
                  device="cpu") -> np.ndarray:
    """The invariant's 32-mers, int32[Q, 32] comp values in text order:
    bench_xlarge.py's draw, the first 32 characters of 2,048 random reads
    of each source piece's sidecar."""
    from ..formats.sidecar import load_creads, sidecar_path

    rng = np.random.default_rng(PATTERN_SEED)
    pats = []
    for seed in PATTERN_SOURCES:
        path = fixtures.build_piece(cache, seed, reads, device)
        creads = load_creads(sidecar_path(path))
        for c in rng.integers(0, creads.shape[1], size=PATTERN_COLUMNS):
            col = creads[:, c]
            if int((col > 0).sum()) >= PATTERN_LEN:
                pats.append(col[:PATTERN_LEN][::-1].astype(np.int32))
        del creads
    return np.stack(pats)


def device_counts(path: str, fmt: str, pattern_sets: Sequence[list],
                  device) -> Tuple[List[np.ndarray], int]:
    """Counts of each pattern set (lists batch_count takes) in one file,
    streamed into the 0.5 B/position nibbles, counted on `device` and
    released; and the file's size."""
    from ..formats.streaming_read import alphabet_for, read_bwt_chunks
    from ..ops.rank_torch import (DeviceFMIndex, batch_count,
                                  pack_nibbles_chunked)

    nib, counts, size, _ = pack_nibbles_chunked(read_bwt_chunks(path, fmt))
    alpha = alphabet_for(fmt, counts, path)
    idx = DeviceFMIndex.from_nibbles(nib, alpha.counts(), size,
                                     device=device)
    del nib
    out = [batch_count(idx, list(p), alpha.char2comp) for p in pattern_sets]
    return out, size


def host_counts(path: str, fmt: str, pattern_sets: Sequence[list]
                ) -> Tuple[List[np.ndarray], int]:
    """device_counts by the host's block-sampled rank, for files past the
    device layout (the full occ table would not fit; each of the few
    hundred thousand rank queries scans O(stride) runs).  The index holds
    5 B a run (SparseRankIndex.from_chunks)."""
    from ..formats.streaming_read import alphabet_for, read_bwt_chunks
    from ..ops.rank_np import SparseRankIndex
    from ..ops.rank_torch import encode_patterns

    sparse = SparseRankIndex.from_chunks(read_bwt_chunks(path, fmt))
    alpha = alphabet_for(fmt, sparse.blk_occ[-1], path)
    out = []
    for p in pattern_sets:
        comps, lens = encode_patterns(list(p), alpha.char2comp)
        sp, ep = sparse.batch_backward_search(
            alpha.C.astype(np.int64), comps.astype(np.int64),
            lens.astype(np.int64))
        out.append(np.maximum(0, ep - sp + 1))
    return out, sparse.size


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; 'cpu'."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def run(cache: Optional[str] = None, reads: int = READS, pieces: int = 2,
        big: int = 0, base_folds: int = len(fixtures.BASE_SEEDS),
        device="cuda", out_path: Optional[str] = None,
        more_patterns: Sequence[list] = ()) -> dict:
    """One tier: fixtures, input counts, the measured fold, the checks.
    The JSON record; raises when a check fails.  The output is removed
    unless `out_path` names it.  `more_patterns`: further pattern sets
    (lists batch_count takes) held to the same invariant, counted with the
    4,096 32-mers on the same indexes."""
    from ..kernels import resolve_device
    from ..models.kfold import merge_files_many
    from ..models.merge import MergeConfig
    from ..ops.rank_torch import MAX_SIZE

    dev = resolve_device(device)
    cache = cache or fixtures.default_cache()
    t_setup = time.monotonic()
    steps: list = []
    paths, fmts = tier_inputs(cache, reads, pieces, big, base_folds, dev,
                              steps)
    fixtures_s = time.monotonic() - t_setup
    pats = read_patterns(cache, reads, dev)
    sets = [list(pats), *more_patterns]
    print(f"# {pats.shape[0]} read-derived 32-mers", file=sys.stderr)

    t0 = time.monotonic()
    want = [np.zeros(len(p), np.int64) for p in sets]
    sizes, memo = [], {}
    for p, f in zip(paths, fmts):
        if p not in memo:
            memo[p] = device_counts(p, f, sets, dev)
        for w, c in zip(want, memo[p][0]):
            w += c
        sizes.append(memo[p][1])
    del memo
    verify_in_s = time.monotonic() - t0
    print(f"# input pattern counts {verify_in_s:.1f}s (sizes "
          f"{[s // 10**6 for s in sizes]} Mbp)", file=sys.stderr)
    setup_s = time.monotonic() - t_setup

    # ---- the measured fold: one k-way streaming merge to a native file ----
    keep = out_path is not None
    out_path = out_path or os.path.join(cache, "xl_merged.native")
    cfg = MergeConfig(device=str(dev), temp_dir=cache, search="auto",
                      verbose=True)
    stats: dict = {}
    with measured(None, "fold", dev) as fold:
        merge_files_many(paths, out_path, fmts, "native", cfg, stats=stats)
    fold_s = fold["s"]
    phases = {k: round(v, 2) for k, v in cfg.timer.phases.items()}
    print(f"# k-way fold: {fold_s:.1f}s  phases={phases}  "
          f"steps={stats.get('step_drained_s')}", file=sys.stderr)
    total_bases = sum(sizes)
    inserted = sum(sizes[1:])

    # ---- the output's checks, outside the fold's window ----
    route = "device" if total_bases <= MAX_SIZE else "host SparseRankIndex"
    with measured(None, f"output check ({route})", dev) as check:
        got, out_size = (device_counts(out_path, "native", sets, dev)
                         if route == "device"
                         else host_counts(out_path, "native", sets))
    verify_out_s = check["s"]
    if out_size != total_bases:
        raise RuntimeError(f"xlarge: output of {out_size} positions, inputs "
                           f"of {total_bases}")
    for g, w in zip(got, want):
        if not np.array_equal(g, w):
            raise RuntimeError(f"xlarge: pattern-count invariant failed "
                               f"({int((g != w).sum())} of {g.size} "
                               f"patterns differ)")
    print(f"# pattern-count invariant OK ({[len(p) for p in sets]} "
          f"patterns, {route}, {verify_out_s:.1f}s)", file=sys.stderr)
    out_mb = os.path.getsize(out_path) / 1e6
    if not keep:
        os.remove(out_path)

    rate = inserted / 1e6 / fold_s
    return {
        "metric": f"xlarge {len(paths)}-way fold throughput",
        "value": rate,
        "unit": "Mbases/s/chip",
        "vs_baseline": rate / BASELINE_MBP_S,
        "extra": {
            "device": device_label(dev),
            "engine": "k-way pairwise-decomposition fold "
                      "(bwtmerge_tpu_torch/models/kfold.py)",
            "inputs": len(paths),
            "total_bases": int(total_bases),
            "base_bases": int(sizes[0]),
            "insert_bases": int(inserted),
            "fold_s": fold_s,
            "sustained_Mbases_s": rate,
            "phase_s": phases,
            "piece_dispatch_s": stats.get("piece_dispatch_s"),
            "step_drained_s": stats.get("step_drained_s"),
            "step_spill_files": stats.get("step_spill_files"),
            "max_window_positions": stats.get("max_window_positions"),
            "output_MB": out_mb,
            "peak_rss_GB": fold["peak_rss_GB"],
            "peak_host_used_GB": fold["peak_host_used_GB"],
            "peak_device_GB": fold["peak_device_GB"],
            "patterns": int(pats.shape[0]),
            "more_patterns": [{"patterns": len(p),
                               "occurrences": int(g.sum())}
                              for p, g in zip(sets[1:], got[1:])],
            "invariant_ok": True,
            "verify_route": route,
            "verify_in_s": verify_in_s,
            "verify_out_s": verify_out_s,
            "verify_out_peak_rss_GB": check["peak_rss_GB"],
            "setup_s": setup_s,
            "fixtures_s": fixtures_s,
            "fixture_steps": steps,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    tier = ap.add_mutually_exclusive_group()
    tier.add_argument("--pieces", type=int, default=2,
                      help="102 Mbp pieces inserted (2: the 3-way tier; 9: "
                           "the 10-way; 27: the 28-way)")
    tier.add_argument("--big", type=int, default=0,
                      help="big pieces inserted instead (6: 3.77 Gbp)")
    ap.add_argument("--reads", type=int, default=READS,
                    help="reads a piece (2,000,000: 102 Mbp)")
    ap.add_argument("--base-folds", type=int,
                    default=len(fixtures.BASE_SEEDS),
                    help="pieces folded into the base's first (6: 714 Mbp)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default=None,
                    help="fixture directory (default .smoke_cache/xl/)")
    args = ap.parse_args(argv)
    if args.pieces < 1 or args.big < 0 or args.big > len(big_pieces.GROUPS):
        ap.error(f"--pieces must be 1 or more, --big 0 to "
                 f"{len(big_pieces.GROUPS)}")
    if not 1 <= args.base_folds <= len(fixtures.BASE_SEEDS):
        ap.error(f"--base-folds must be 1 to {len(fixtures.BASE_SEEDS)}")
    print(json.dumps(run(args.cache, args.reads, args.pieces, args.big,
                         args.base_folds, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
