#!/usr/bin/env python3
"""Drive the PyTorch port (bwtmerge_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the card's name and power limit, from nvidia-smi;
2. build: the CUDA kernels (csrc/*.cu, one nvcc each, in parallel) and the
   native host library; then every fixture starts building in a pool of
   worker processes, overlapping the phases below;
3. kernels: each kernel against its plain PyTorch version on the card,
   compared for exact equality (all integer) and timed with CUDA events:
   K1 and K2 at the main path's shapes, K1 also at the trie search's (a
   sorted batch of many equal neighbours that ends in queries equal to
   the size), K2 also with every lane starting at a super-block's edge
   or at the table's last position, K3
   (the read decode) on the real BWT of 10^6 reads of 1..24 characters
   plus one of 100, past the 64-row cap, with lanes starting at block
   offsets 0 and 31; the full decode must also give back the generated
   reads.  The kernels that build K2's and K3's tables (walk_planes_build,
   decode_rows_build) are held against their plain versions on the same
   record tables.  Each kernel's bound is computed from these inputs;
4. small exact merge: 20k + 10k random 50 bp reads merged by the port on
   the card (in three read blocks) and by the port's plain numpy
   reference (ops/search_np.py, ops/interleave_np.py); the files must be
   byte-identical;
5. small exact fold: four pieces (20k, then three of 10k reads, seeds
   21-24) folded by the port on the card, lane-blocked on step 2, against
   the numpy reference's left fold; byte-identical files;
6. small exact trie merge: the pair of phase 4 merged on the card with
   search='trie' in two sequence blocks, by the streamed steps and by the
   gather steps; both files byte-identical to the numpy reference's and
   to the walk's of phase 4.  Then a fold of three pieces, one holding a
   read of 2^14 + 100 characters: the fold must leave for the pairwise
   chain on the trie search and give the numpy reference's bytes;
   then kernel_times: K2 and its table's build at the two-input main
   path's own shape (held against their plain versions there too) and
   over a table that fits the L2, K3 on a third of the positions, the
   table builds beside build_cplanes (torch ops);
7. main path, two inputs: bwt_merge A B out -v patterns --device cuda at
   bench.py's medium scale (524k + 262k reads of 50 bp, B with its
   read-text sidecar, 2^18 patterns of 32 bp); it must exit 0 (the -v
   counts agree), the merged symbol counts must equal A's plus B's, and
   K1, K2 and walk_planes_build must have launched during the run;
8. main path, k-way fold: bwt_merge P0 P1 P2 P3 out -v patterns --device
   cuda with P0, P1 = A, B above and P2, P3 = 262k-read pieces without
   sidecars (seeds 4 and 5), 67 Mbp over three fold steps; exit 0, merged
   symbol counts equal to the pieces' sum, and K1 >= 1, K2 >= 6, K3 >= 3
   and each table's build kernel >= 3 launches during the run;
9. main path, trie: bwt_merge A B out -v patterns --search trie --device
   cuda on the pair of phase 7; exit 0, merged symbol counts equal to A's
   plus B's, the output byte-identical to phase 7's, and K1 launched at
   least 100 times beyond phase 7's count (its -v passes): twice or more
   per depth.  Then the search alone on the same pair, streamed and with
   gathers, timed per depth, and the streamed search under the profiler
   for the device time in probes and in sorts.

After these, the phases of construction, the interleaves and the CLIs:

10. CLI gaps (on the small pair): bwt_merge --backend numpy
    -r 0 -m 2 -b 0 -d DIR must write spill files under DIR and the small
    merge's bytes (-r counts millions of runs, so at this size only -r 0
    spills); bwt_convert SGA -> native -> SGA must give back the file; bwt_inspect's totals must equal
    the fixtures'; the small merge through MergeConfig(interleave="device")
    must equal the native chain's file;
11. construction timing: bench.py's large A (2,000,000 reads of
    50 bp, 102 M positions) built on the card by build_from_reads(backend=
    "torch"); symbol counts equal the reads', endmarkers the read count;
    rounds, seconds a round and Mbases/s;
12. construction at full width: the medium A and B built
    on the card, written as SGA and byte-compared with the fixtures the
    numpy oracle built; rlo_order_device on the medium A against rlo_order;
    the bwt_build CLI on a plain reads file of the medium B, output and
    sidecar byte-identical to the fixture's;
13. interleaves at the medium size: the medium merge through
    MergeConfig(interleave="device"), byte-identical to phase 7's file,
    with the device time of the scatters and of the run-length pass; the
    medium pair's rank array through the serial host chain and through
    interleave_stream_chunks_parallel + coalesce_run_chunks and the writer,
    byte-identical files, both chains' seconds;

Then the multi-device paths, on meshes that repeat the one card:

14. the rank array's budget: the medium walk merge with -r 1 -m 2 -d DIR
    (2 Mi runs held), in its own blocking and in eight read blocks; spill
    files under DIR, the main path's bytes, the peak of the pinned host
    bytes alive beside the main path's;
15. meshes: the medium merge over [cuda:0] * 2 and * 4 through the four
    routes of a mesh (the walk, the trie a block a shard, the dynamic
    queue of 16 blocks, the record tables split over the mesh), each file
    byte-identical to the main path's, K2 and K1 launched once a shard or
    more where their route runs (walk_planes_build once: one distinct
    device), per-shard runs and search seconds; sharded_backward_search
    of the patterns equal to the single-device counts;
16. bwt_merge -t 2 --device cuda: status 1 naming torch.cuda.device_count()
    on one GPU, the main path's bytes on two or more;
17. a torch.distributed world of two processes on gloo, each on the card
    (this script again, as `--multihost-worker RANK PORT A B DIR DEVICE`):
    the medium merge into SGA and native, each byte-identical to the
    single-device merge's; the exchange's figures per process;
18. build_bwt_sharded of the medium A over [cuda:0] * 4, byte-identical to
    the single-device build, both timed; then one line of what one card
    cannot show (copies between GPUs, NCCL);
19. bwt_merge --profile DIR on the small pair must leave one non-empty
    trace and the small merge's bytes (last of all: a profiler, once started,
    leaves its tracing library loaded, and later launches pay for it).

Phases 7, 9, 14 and 15 also log the pinned host bytes that the rank
array's blocks held (ops/ra_stream.py), beside B's size.

The launch counts are set to 0 just before each main path and each
multi-device phase and read just after.  The second-to-last line is the
kernels' JSON record, the last line {"ok": true, "device": {...}}.  Fixtures are cached in .smoke_cache/.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import multiprocessing
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".smoke_cache")
READ_LEN = 50
MEDIUM = (524_000, 262_000)      # bench.py SCALES["medium"] reads
SMALL = (20_000, 10_000)
FOLD_SMALL = ((20_000, 21), (10_000, 22), (10_000, 23), (10_000, 24))
FOLD_EXTRA = ((262_000, 4), (262_000, 5))     # P2, P3 of the medium fold
LONG_FOLD = ((2_000, 41), (1_000, 42), (1_000, 43))   # piece 1 has the long read
LONG_READ = (1 << 14) + 100
K3_READS = 1_000_000
K3_MAX_LEN = 24
K3_LONG = 100
K3_CAP = 64
K1_POSITIONS = 100_000_000
K1_QUERIES = 1 << 20
K1_SENTINELS = 4096
K2_SHAPE = (50, 1 << 20)
K2_SMALL_POSITIONS = 10_000_000   # a walk table that fits the card's L2
K3_SHORT_MAX_LEN = 6              # reads of the decode's small-table fixture
N_PATTERNS = 1 << 18
PATTERN_LEN = 32
LARGE_A_READS = 2_000_000         # bench.py SCALES["large"], A


def log(msg: str) -> None:
    print(msg, flush=True)


# -- fixtures -----------------------------------------------------------------


def reads_of(m: int, seed: int) -> np.ndarray:
    """The reads of a fixture: comp values 1..4, [m, READ_LEN] (the first
    draw of bench.py's _build_fixture recipe)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, size=(m, READ_LEN))


def build_fixture(path: str, m: int, seed: int, sidecar: bool) -> str:
    """SGA file of the BWT of m random 50 bp reads (bench.py:65-98's
    recipe), with the read-text sidecar when asked.  Cached by path."""
    if os.path.exists(path) and (not sidecar or os.path.exists(path + ".reads4")):
        return path
    from bwtmerge_tpu_torch.formats import write_bwt
    from bwtmerge_tpu_torch.formats.sidecar import sidecar_path, write_sidecar
    from bwtmerge_tpu_torch.models.oracle import suffix_array
    from bwtmerge_tpu_torch.models.runs import RunArrays
    from bwtmerge_tpu_torch.utils.alphabet import Alphabet

    os.makedirs(os.path.dirname(path), exist_ok=True)
    mat = np.empty((m, READ_LEN + 1), dtype=np.int64)
    mat[:, :READ_LEN] = reads_of(m, seed) + m
    mat[:, READ_LEN] = np.arange(m)
    if sidecar:
        write_sidecar(sidecar_path(path), np.full(m, READ_LEN, np.uint32),
                      (mat[:, :READ_LEN] - m).astype(np.uint8).reshape(-1))
    text = mat.reshape(-1)
    del mat
    sa = suffix_array(text)
    prev = text[sa - 1]
    bwt = np.where((sa % (READ_LEN + 1) == 0) | (prev < m), 0, prev - m)
    runs = RunArrays.from_values(bwt.astype(np.uint8))
    write_bwt(path, "sga", runs, Alphabet.from_counts(runs.counts(6)))
    return path


def mixed_lengths(m: int, seed: int) -> np.ndarray:
    """Read lengths of the decode fixture: 1..K3_MAX_LEN, read m // 2 of
    K3_LONG characters."""
    lens = np.random.default_rng(seed).integers(1, K3_MAX_LEN + 1, size=m)
    lens[m // 2] = K3_LONG
    return lens


def short_lengths(m: int, seed: int) -> np.ndarray:
    """Read lengths of the decode's small-table fixture: 1..K3_SHORT_MAX_LEN
    (as many lanes as the decode fixture over a third of its positions)."""
    return np.random.default_rng(seed).integers(1, K3_SHORT_MAX_LEN + 1,
                                                size=m)


def long_lengths(m: int, seed: int) -> np.ndarray:
    """Read lengths of the long-read piece: READ_LEN, read m // 2 of
    LONG_READ characters (past the walk's cap of 2^14)."""
    lens = np.full(m, READ_LEN)
    lens[m // 2] = LONG_READ
    return lens


def mixed_text(m: int, seed: int, lengths=mixed_lengths) -> np.ndarray:
    """The text of a fixture of reads of several lengths: read k as comp
    values 1..4 plus m, then its endmarker k (so endmarkers sort first, in
    read order)."""
    ends = np.cumsum(lengths(m, seed) + 1) - 1
    rng = np.random.default_rng(seed + 1)
    text = rng.integers(1, 5, size=int(ends[-1]) + 1) + m
    text[ends] = np.arange(m)
    return text


def build_mixed_fixture(path: str, m: int, seed: int,
                        lengths=mixed_lengths) -> str:
    """SGA file of the collection BWT of mixed_text(m, seed, lengths).
    Cached."""
    if os.path.exists(path):
        return path
    from bwtmerge_tpu_torch.formats import write_bwt
    from bwtmerge_tpu_torch.models.oracle import suffix_array
    from bwtmerge_tpu_torch.models.runs import RunArrays
    from bwtmerge_tpu_torch.utils.alphabet import Alphabet

    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = mixed_text(m, seed, lengths)
    sa = suffix_array(text)
    prev = text[sa - 1]              # sa == 0 wraps to the last endmarker
    bwt = np.where(prev < m, 0, prev - m).astype(np.uint8)
    runs = RunArrays.from_values(bwt)
    write_bwt(path, "sga", runs, Alphabet.from_counts(runs.counts(6)))
    return path


class Fixtures:
    """Every fixture of the run, built in worker processes (spawned, so no
    CUDA state is inherited) while the card runs the earlier phases.
    `get(key)` waits for one; leaving the `with` block stops the pool."""

    def __init__(self, workers: int = 6):
        ctx = multiprocessing.get_context("spawn")
        self._pool = concurrent.futures.ProcessPoolExecutor(workers,
                                                            mp_context=ctx)
        self._jobs = {}
        self.t0 = time.monotonic()
        small = os.path.join(CACHE, "small")
        fold_small = os.path.join(CACHE, "fold_small")
        medium = os.path.join(CACHE, f"medium_{MEDIUM[0]}_{MEDIUM[1]}")
        fold = os.path.join(CACHE, "fold_medium")
        jobs = [("small_a", build_fixture, os.path.join(
                    small, f"a_{SMALL[0]}.sga"), SMALL[0], 11, False),
                ("small_b", build_fixture, os.path.join(
                    small, f"b_{SMALL[1]}.sga"), SMALL[1], 12, True)]
        jobs += [(f"fold_small_{k}", build_fixture,
                  os.path.join(fold_small, f"p{k}_{m}_{seed}.sga"), m, seed,
                  False) for k, (m, seed) in enumerate(FOLD_SMALL)]
        long_fold = os.path.join(CACHE, "fold_long")
        jobs += [(f"fold_long_{k}", build_fixture,
                  os.path.join(long_fold, f"p{k}_{m}_{seed}.sga"), m, seed,
                  False) for k, (m, seed) in enumerate(LONG_FOLD) if k != 1]
        jobs += [("fold_long_1", build_mixed_fixture, os.path.join(
                      long_fold, f"p1_{LONG_FOLD[1][0]}_{LONG_FOLD[1][1]}.sga"),
                  *LONG_FOLD[1], long_lengths)]
        jobs += [("a", build_fixture, os.path.join(medium, "a.sga"),
                  MEDIUM[0], 1, False),
                 ("k3", build_mixed_fixture, os.path.join(
                     CACHE, f"decode_{K3_READS}.sga"), K3_READS, 31),
                 ("b", build_fixture, os.path.join(medium, "b.sga"),
                  MEDIUM[1], 2, True),
                 ("k3_short", build_mixed_fixture, os.path.join(
                     CACHE, f"decode_short_{K3_READS}.sga"), K3_READS, 33,
                  short_lengths)]
        jobs += [(f"p{k + 2}", build_fixture,
                  os.path.join(fold, f"p{k + 2}_{m}_{seed}.sga"), m, seed,
                  False) for k, (m, seed) in enumerate(FOLD_EXTRA)]
        for key, fn, *args in jobs:
            self._jobs[key] = self._pool.submit(fn, *args)

    def get(self, key: str) -> str:
        return self._jobs[key].result()

    def __enter__(self) -> "Fixtures":
        return self

    def __exit__(self, *exc) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


def write_patterns(path: str, sources, n: int, seed: int) -> str:
    """n patterns of PATTERN_LEN: half cut from the reads, half random."""
    from bwtmerge_tpu_torch.utils.alphabet import Alphabet

    rng = np.random.default_rng(seed)
    half = n // 2
    reads = np.concatenate(sources)
    rows = rng.integers(0, reads.shape[0], size=half)
    offs = rng.integers(0, READ_LEN - PATTERN_LEN + 1, size=half)
    cut = reads[rows[:, None], offs[:, None] + np.arange(PATTERN_LEN)]
    rand = rng.integers(1, 5, size=(n - half, PATTERN_LEN))
    comps = np.concatenate([cut, rand]).astype(np.uint8)
    chars = Alphabet().comp2char[comps]
    with open(path, "wb") as f:
        f.write(b"\n".join(bytes(r) for r in chars) + b"\n")
    return path


# -- phases -------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def build_all() -> dict:
    from bwtmerge_tpu_torch import kernels
    from bwtmerge_tpu_torch.native.build import build_library

    t0 = time.monotonic()
    kernels.build(force=True)
    t1 = time.monotonic()
    build_library()
    t2 = time.monotonic()
    return {"kernels_s": t1 - t0, "native_s": t2 - t1}


def time_ms_cold(fn, device, iters: int = 10,
                 fill_bytes: int = 256 << 20) -> float:
    """Mean milliseconds per call when 256 MB are written through the L2
    before each call: what a caller pays whose last kernel was another."""
    import torch

    fill = torch.empty(fill_bytes, dtype=torch.uint8, device=device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    total = 0.0
    for _ in range(iters):
        fill.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        total += start.elapsed_time(end)
    return total / iters


def time_ms(fn, device, iters: int = 20) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls
    after two warm-up calls (host clock and a synchronise on the CPU)."""
    import torch

    for _ in range(2):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): memory rate,
# and the float32 rate outside the tensor cores, which stands in for the
# int32 compares and adds these kernels do (the sheet gives no int32 rate).
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
COPY_BYTES_S = None       # this card's device-to-device copy rate, measured


def measure_copy_rate(device, n_bytes: int = 1 << 30) -> float:
    """Bytes read plus bytes written per second by a device-to-device copy
    of n_bytes: what this card's memory gives a kernel that streams."""
    import torch

    global COPY_BYTES_S
    src = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    COPY_BYTES_S = 2 * n_bytes / (time_ms(lambda: dst.copy_(src), device)
                                  * 1e-3)
    log(f"device copy of {n_bytes} B: {COPY_BYTES_S / 1e9:.1f} GB/s read + "
        f"write (data sheet {HBM_BYTES_S / 1e9:.0f} GB/s)")
    return COPY_BYTES_S


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: the larger of the bytes that
    must move over its memory rate and the operations over its peak.
    bound_ms_at_copy_rate is the bytes over the measured copy rate."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / ALU_OPS_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_ops": int(n_ops),
            "bound_ms_at_copy_rate": (n_bytes / COPY_BYTES_S * 1e3
                                      if COPY_BYTES_S else None),
            # no single PyTorch call computes any of these functions
            "library_ms": None}


def probe_bound(rec, q, size: int) -> dict:
    """K1's bound on these queries: every query read (4 B) and its output
    column written (OUT_W int32), and each record that some query falls in
    read once (64 B; queries past the size touch none).  Operations: a
    compare and an add per position of the block and occ lane."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_streamed import OUT_W
    from bwtmerge_tpu_torch.ops.rank_torch import BLK, LANES

    live = q[q <= size]
    blocks = int(torch.unique_consecutive(live >> 5).numel())
    n_bytes = q.numel() * (4 + 4 * OUT_W) + blocks * rec.shape[1] * 4
    return bound(n_bytes, int(live.numel()) * BLK * LANES * 2)


def walk_bound(creads, steps: int, planes, nblk: int) -> dict:
    """K2's bound: creads read (1 B a cell), emits written (4 B a cell), and
    one 32 B plane row per live lane-step, or the whole of the planes where
    that is less.  Operations: seven masks and popcounts and two adds a
    live step.  bound_ms_narrow_table is the same with the table the kernel
    read before it had the wide planes (8 B a step, or 1.25 B a position):
    what its earlier times were held against."""
    out = bound(creads.numel() * 5 + min(steps * 32, planes.numel() * 4),
                steps * 16)
    out["bound_ms_narrow_table"] = bound(
        creads.numel() * 5 + min(steps * 8, nblk * planes.shape[1] * 8),
        steps * 6)["bound_ms"]
    return out


def decode_bound(creads, steps: int, rows) -> dict:
    """K3's bound: creads written (1 B a cell) and one 32 B decode row per
    live lane-step (each read's characters, capped, and its endmarker), or
    the whole of the rows where that is less.  Operations: some fifteen a
    live step.  bound_ms_record_table is the same with the 64 B records
    the kernel read before it had the decode rows: what its earlier times
    were held against."""
    out = bound(creads.numel() + min(steps * 32, rows.numel() * 4),
                steps * 15)
    out["bound_ms_record_table"] = bound(
        creads.numel() + min(steps * 64, rows.numel() * 8),
        steps * 64)["bound_ms"]
    return out


def random_index(n_pos: int, device, seed: int):
    """A DeviceFMIndex over n_pos random symbols 0..5, built on the device
    from the symbols themselves (a probe needs no valid BWT)."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import (BLK, SIGMA, DeviceFMIndex,
                                                   build_rec, c_array)

    gen = torch.Generator(device=device).manual_seed(seed)
    syms = torch.randint(0, SIGMA, (n_pos,), generator=gen, device=device,
                         dtype=torch.uint8)
    nblk = n_pos // BLK + 1
    text = torch.full((nblk * BLK,), SIGMA, dtype=torch.uint8, device=device)
    text[:n_pos] = syms
    blocks = text.view(nblk, BLK)
    nibbles = (blocks[:, :16] | (blocks[:, 16:] << 4)).reshape(-1)
    counts = torch.bincount(syms, minlength=SIGMA).cpu().numpy()
    return DeviceFMIndex(rec=build_rec(nibbles, nblk),
                         C=torch.from_numpy(c_array(counts)).to(device),
                         size=n_pos, n_runs=0)


def random_creads(shape, gen, device):
    """Walk-layout reads int8[max_len, R] of random lengths 1..max_len and
    random characters 1..5, 0 past each read's start."""
    import torch

    max_len, r = shape
    lens = torch.randint(1, max_len + 1, (r,), generator=gen, device=device)
    chars = torch.randint(1, 6, (max_len, r), generator=gen, device=device)
    rows = torch.arange(max_len, device=device)[:, None]
    return torch.where(rows < lens[None, :], chars, 0).to(torch.int8)


def kernel_times(device, fixtures: Fixtures) -> dict:
    """K2 and K3 timed alone, with their tables' builds: K2 at K2_SHAPE over
    random indexes of K2_SMALL_POSITIONS (a table that fits the L2) and
    K1_POSITIONS (one that does not), and at the two-input main path's
    shape (the medium A's index, B's reads), there held against the plain
    versions and also timed with the L2 filled before each call; K3 on the
    decode fixture and on as many reads of 1..K3_SHORT_MAX_LEN characters (a
    third of the positions); picoseconds per live step beside each."""
    import torch

    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.formats import read_bwt
    from bwtmerge_tpu_torch.ops.decode_torch import (build_decode_rows,
                                                     decode_creads_device)
    from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex
    from bwtmerge_tpu_torch.ops.walk_torch import (build_cplanes,
                                                   build_walk_planes,
                                                   build_walk_planes_plain,
                                                   walk_emit, walk_emit_plain)

    out = {}

    def walk_case(idx, creads, main_path=False):
        planes = build_walk_planes(idx.rec)
        a0 = int(idx.C[1])
        steps = int((creads > 0).sum())
        run = lambda: walk_emit(planes, idx.C, creads, a0)   # noqa: E731
        rec = {"positions": idx.size, "creads": list(creads.shape),
               "steps": steps, "planes_bytes": planes.numel() * 4,
               "ms": time_ms(run, device),
               "planes_build_ms": time_ms(
                   lambda: build_walk_planes(idx.rec), device, 5),
               "build_cplanes_ms": time_ms(lambda: build_cplanes(idx.rec),
                                           device, 5),
               **walk_bound(creads, steps, planes, idx.rec.shape[0])}
        rec["ps_per_step"] = rec["ms"] * 1e9 / steps
        if main_path:
            if not torch.equal(planes, build_walk_planes_plain(idx.rec)):
                raise AssertionError("walk_planes_build differs from its "
                                     "plain version on the medium A's index")
            e_got, n_got = run()
            e_want, n_want = walk_emit_plain(planes, idx.C, creads, a0)
            if not (torch.equal(e_got, e_want) and int(n_got) == int(n_want)):
                raise AssertionError("walk_emit differs from its plain "
                                     "version at the main path's shape")
            rec["ms_l2_filled"] = time_ms_cold(run, device)
        return rec

    gen = torch.Generator(device=device).manual_seed(8)
    creads = random_creads(K2_SHAPE, gen, device)
    for n_pos in (K2_SMALL_POSITIONS, K1_POSITIONS):
        out[f"walk_random_{n_pos}"] = walk_case(
            random_index(n_pos, device, 7), creads)
    del creads
    a = port.load_fmi(fixtures.get("a"), "sga")
    b = port.load_fmi(fixtures.get("b"), "sga")
    out["walk_main_path"] = walk_case(
        a.device_index(device), torch.from_numpy(b.creads()).to(device),
        main_path=True)

    for key, lengths, seed in (("k3", mixed_lengths, 31),
                               ("k3_short", short_lengths, 33)):
        runs, _, _ = read_bwt(fixtures.get(key), "sga")
        idx = DeviceFMIndex.build(runs, runs.counts(6), device)
        m = int(idx.C[1])
        steps = int(np.minimum(lengths(m, seed) + 1, K3_CAP).sum())
        buf = torch.zeros((K3_CAP, m), dtype=torch.int8, device=device)
        rows = build_decode_rows(idx.rec)
        rec = {"positions": idx.size, "creads": list(buf.shape),
               "steps": steps, "rows_bytes": rows.numel() * 4,
               "ms": time_ms(lambda: decode_creads_device(idx, buf,
                                                          rows=rows), device),
               "ms_with_rows_build": time_ms(
                   lambda: decode_creads_device(idx, buf), device),
               "rows_build_ms": time_ms(lambda: build_decode_rows(idx.rec),
                                        device),
               **decode_bound(buf, steps, rows)}
        rec["ps_per_step"] = rec["ms"] * 1e9 / steps
        out[f"decode_{key}"] = rec
    log(f"kernel times: {json.dumps(out)}")
    return out


def check_kernels(device, n_pos: int, n_q: int, n_sent: int,
                  walk_shape, seed: int = 7) -> list:
    """Each kernel's wrapper against its plain version on the same device
    tensors; exact equality.  Returns the per-kernel records."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_streamed import (streamed_probe,
                                                      streamed_probe_plain)
    from bwtmerge_tpu_torch.ops.rank_torch import BLK
    from bwtmerge_tpu_torch.ops.walk_torch import (NC, SUPER, build_cplanes,
                                                   build_walk_planes,
                                                   build_walk_planes_plain,
                                                   walk_emit, walk_emit_plain)

    idx = random_index(n_pos, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    q = torch.sort(torch.randint(0, n_pos + 1, (n_q,), generator=gen,
                                 device=device)).values
    q[-1] = n_pos                                     # q == size
    q = torch.cat([q, torch.full((n_sent,), 2**31 - 1, device=device,
                                 dtype=q.dtype)]).to(torch.int32)
    got = streamed_probe(idx.rec, q, idx.size)
    want = streamed_probe_plain(idx.rec, q, idx.size)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"streamed_probe differs from its plain version "
                             f"(max abs err {err})")
    k1 = {"name": "streamed_probe", "route": "cuda",
          "source": "bwtmerge_tpu_torch/csrc/streamed_probe.cu",
          "replaces": "bwtmerge_tpu/ops/rank_pallas.py:58",
          "max_abs_err": err,
          "ms": time_ms(lambda: streamed_probe(idx.rec, q, idx.size), device),
          "plain_ms": time_ms(
              lambda: streamed_probe_plain(idx.rec, q, idx.size), device),
          **probe_bound(idx.rec, q, idx.size)}
    log(f"K1 streamed_probe: {n_pos} positions, {n_q} sorted queries + "
        f"{n_sent} sentinels: equal, {k1['ms']:.4f} ms vs plain "
        f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms")

    # the trie search's batches: a frontier's b_sp at depths 1-3 is sorted
    # with long runs of equal neighbours, and its last b_ep + 1 is the size
    for name, distinct in (("depth-1", 4), ("depth-3", 64),
                           ("singles", n_q // 4)):
        qt = torch.sort(torch.randint(0, n_pos, (distinct,), generator=gen,
                                      device=device)).values
        qt = qt.repeat_interleave(n_q // 4 // distinct)
        qt = torch.cat([qt, torch.full((17,), n_pos, device=device,
                                       dtype=qt.dtype)]).to(torch.int32)
        got = streamed_probe(idx.rec, qt, idx.size)
        want = streamed_probe_plain(idx.rec, qt, idx.size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        k1["max_abs_err"] = max(k1["max_abs_err"], e)
        if not torch.equal(got, want):
            raise AssertionError(f"streamed_probe differs from its plain "
                                 f"version on the trie's {name} batch (max "
                                 f"abs err {e})")
        ms = time_ms(lambda: streamed_probe(idx.rec, qt, idx.size), device)
        log(f"K1 streamed_probe, trie {name} batch: {qt.numel()} queries, "
            f"{distinct} distinct + 17 equal to the size: equal, {ms:.4f} ms, "
            f"bound {probe_bound(idx.rec, qt, idx.size)['bound_ms']:.4f} ms")

    # the walk's table: its build kernel against its plain version
    planes = build_walk_planes(idx.rec)
    planes_want = build_walk_planes_plain(idx.rec)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = int((planes.to(torch.int64) - planes_want.to(torch.int64)
               ).abs().max())
    if not torch.equal(planes, planes_want):
        raise AssertionError(f"walk_planes_build differs from its plain "
                             f"version (max abs err {err})")
    del planes_want
    # its bound: the symbol half of every record and the occ half of every
    # seventh read (32 B each), the planes written once; a compare and an or
    # per position and character
    kb = {"name": "walk_planes_build", "route": "cuda",
          "source": "bwtmerge_tpu_torch/csrc/walk.cu",
          "replaces": "bwtmerge_tpu/ops/walk_jax.py:99",
          "max_abs_err": err,
          "ms": time_ms(lambda: build_walk_planes(idx.rec), device),
          "plain_ms": time_ms(lambda: build_walk_planes_plain(idx.rec),
                              device, 3),
          "narrow_planes_torch_ms": time_ms(lambda: build_cplanes(idx.rec),
                                            device, 3),
          **bound((idx.rec.shape[0] + planes.shape[0]) * 32
                  + planes.numel() * 4, idx.rec.shape[0] * BLK * NC * 2)}
    log(f"walk_planes_build: {n_pos} positions, planes "
        f"{list(planes.shape)}: equal, {kb['ms']:.4f} ms vs plain "
        f"{kb['plain_ms']:.4f} ms (build_cplanes "
        f"{kb['narrow_planes_torch_ms']:.4f} ms), bound "
        f"{kb['bound_ms']:.4f} ms")

    creads = random_creads(walk_shape, gen, device)
    lens = (creads > 0).sum(dim=0)
    a0 = int(idx.C[1])
    e_want, n_want = walk_emit_plain(planes, idx.C, creads, a0)
    e_got, n_got = walk_emit(planes, idx.C, creads, a0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = int((e_got.to(torch.int64) - e_want.to(torch.int64)).abs().max())
    if not (torch.equal(e_got, e_want) and int(n_got) == int(n_want)):
        raise AssertionError(
            f"walk_emit differs from its plain version (max abs err {err}, "
            f"n_live {int(n_got)} vs {int(n_want)})")
    if int(n_want) != int(lens.sum()):
        raise AssertionError("walk_emit n_live is not the creads length sum")
    # every lane starting at one a0: the first and last positions of a
    # super-block and their neighbours, and the table's last position
    last = n_pos // SUPER * SUPER
    short = creads[:4, :1024].contiguous()
    for a_edge in sorted(x for x in {0, 1, 31, 32, SUPER - 1, SUPER,
                                     SUPER + 1, 2 * SUPER - 1, 2 * SUPER,
                                     last - 1, last, n_pos - 1, n_pos}
                         if 0 <= x <= n_pos):
        e_got, n_got = walk_emit(planes, idx.C, short, a_edge)
        e_ref, n_ref = walk_emit_plain(planes, idx.C, short, a_edge)
        if not (torch.equal(e_got, e_ref) and int(n_got) == int(n_ref)):
            raise AssertionError(f"walk_emit differs from its plain version "
                                 f"with every lane starting at {a_edge}")
    steps = int(n_want)
    k2 = {"name": "walk_emit", "route": "cuda",
          "source": "bwtmerge_tpu_torch/csrc/walk.cu",
          "replaces": "bwtmerge_tpu/ops/walk_jax.py:133",
          "max_abs_err": err,
          "ms": time_ms(lambda: walk_emit(planes, idx.C, creads, a0), device),
          "plain_ms": time_ms(
              lambda: walk_emit_plain(planes, idx.C, creads, a0), device, 5),
          **walk_bound(creads, steps, planes, idx.rec.shape[0])}
    log(f"K2 walk_emit: creads {list(creads.shape)}, {steps} live steps, "
        f"planes {planes.numel() * 4} B: equal, also at the super-block "
        f"edges, {k2['ms']:.4f} ms vs plain {k2['plain_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_ms_narrow_table']:.4f} ms "
        f"with the narrow table)")
    return [k1, k2, kb]


def check_decode(device, path: str, m: int = K3_READS, seed: int = 31,
                 cap: int = K3_CAP) -> list:
    """K3 against decode_creads_plain on the same device tensors, exact:
    every lane at once, then narrow slabs starting at block offsets 0 and
    31 (lane l starts at BWT row l).  The full decode, with its cap
    doubling, must give back the generated reads.  Returns K3's record."""
    import torch

    from bwtmerge_tpu_torch.formats import read_bwt
    from bwtmerge_tpu_torch.formats.sidecar import creads_layout
    from bwtmerge_tpu_torch.ops.decode_torch import (build_decode_rows,
                                                     build_decode_rows_plain,
                                                     decode_creads,
                                                     decode_creads_device,
                                                     decode_creads_plain)
    from bwtmerge_tpu_torch.ops.rank_torch import BLK, DeviceFMIndex

    runs, _, _ = read_bwt(path, "sga")
    idx = DeviceFMIndex.build(runs, runs.counts(6), device)
    # the decode's table: its build kernel against its plain version
    rows = build_decode_rows(idx.rec)
    rows_want = build_decode_rows_plain(idx.rec)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = int((rows.to(torch.int64) - rows_want.to(torch.int64)).abs().max())
    if not torch.equal(rows, rows_want):
        raise AssertionError(f"decode_rows_build differs from its plain "
                             f"version (max abs err {err})")
    # its bound: the record table read once, the rows written once; a
    # shift, a mask and an or per position and bit-plane
    kb = {"name": "decode_rows_build", "route": "cuda",
          "source": "bwtmerge_tpu_torch/csrc/decode.cu",
          "replaces": "bwtmerge_tpu/ops/walk_jax.py:272",
          "max_abs_err": err,
          "ms": time_ms(lambda: build_decode_rows(idx.rec), device),
          "plain_ms": time_ms(lambda: build_decode_rows_plain(idx.rec),
                              device, 5),
          **bound(idx.rec.numel() * 4 + rows.numel() * 4,
                  idx.rec.shape[0] * BLK * 3 * 3)}
    log(f"decode_rows_build: {idx.size} positions, rows {list(rows.shape)}: "
        f"equal, {kb['ms']:.4f} ms vs plain {kb['plain_ms']:.4f} ms, bound "
        f"{kb['bound_ms']:.4f} ms")
    err = 0
    for lane0, width in ((0, m), (0, 1000), (31, 1000), (32, 33),
                         (m // 2 - 31, 64), (m - 500, 500)):
        got = torch.zeros((cap, width), dtype=torch.int8, device=device)
        want = torch.zeros_like(got)
        n_got = decode_creads_device(idx, got, lane0)
        n_want = decode_creads_plain(idx, want, lane0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        err = max(err, int((got.to(torch.int16) - want.to(torch.int16)
                            ).abs().max()))
        if not torch.equal(got, want) or int(n_got) != int(n_want):
            raise AssertionError(
                f"decode differs from its plain version at lanes {lane0}.."
                f"{lane0 + width - 1} (max abs err {err}, alive "
                f"{int(n_got)} vs {int(n_want)})")
        if int(n_got) != (1 if lane0 <= m // 2 < lane0 + width else 0):
            raise AssertionError(f"decode: {int(n_got)} lanes alive at the "
                                 f"cap in lanes {lane0}..")

    lens = mixed_lengths(m, seed)
    text = mixed_text(m, seed)
    flat = (text[text >= m] - m).astype(np.uint8)
    decoded = decode_creads(idx, m, idx.size)
    if not np.array_equal(decoded, creads_layout(lens.astype(np.uint32),
                                                 flat)):
        raise AssertionError("decode did not give back the reads")

    steps = int(np.minimum(lens + 1, cap).sum())
    buf = torch.zeros((cap, m), dtype=torch.int8, device=device)
    rec = {"name": "decode", "route": "cuda",
           "source": "bwtmerge_tpu_torch/csrc/decode.cu",
           "replaces": "bwtmerge_tpu/ops/walk_jax.py:280",
           "max_abs_err": err,
           "ms": time_ms(lambda: decode_creads_device(idx, buf, rows=rows),
                         device),
           "ms_with_rows_build": time_ms(
               lambda: decode_creads_device(idx, buf), device),
           "plain_ms": time_ms(lambda: decode_creads_plain(idx, buf), device,
                               5),
           **decode_bound(buf, steps, rows)}
    log(f"K3 decode: {m} reads ({idx.size} positions), creads [{cap}, {m}], "
        f"{steps} live steps: equal, reads recovered, {rec['ms']:.4f} ms "
        f"over given rows, {rec['ms_with_rows_build']:.4f} ms with their "
        f"build, vs plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_ms_record_table']:.4f} ms "
        f"with the record table)")
    return [rec, kb]


def numpy_merge(a, b):
    """The port's plain reference merge, on the host in numpy and
    independent of the device path: the trie search over the host rank
    index (ops/search_np.py), then the position-by-position interleave
    (ops/interleave_np.py).  Takes and returns FMIs."""
    from bwtmerge_tpu_torch.models.fmi import FMI
    from bwtmerge_tpu_torch.ops.interleave_np import interleave
    from bwtmerge_tpu_torch.ops.search_np import build_rank_array

    values, counts = build_rank_array(
        a.rank_index, a.alpha.C.astype(np.int64),
        b.rank_index, b.alpha.C.astype(np.int64),
        a.sequences(), b.sequences())
    return FMI.from_runs(interleave(a.runs, b.runs, values, counts))


def numpy_fold(paths, out: str) -> None:
    """Left fold of numpy_merge over SGA files, written to `out`."""
    import bwtmerge_tpu_torch as port

    acc = port.load_fmi(paths[0], "sga")
    for p in paths[1:]:
        acc = numpy_merge(acc, port.load_fmi(p, "sga"))
    port.serialize_fmi(acc, out, "sga")


def same_bytes(got: str, want: str, what: str) -> None:
    with open(got, "rb") as f1, open(want, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError(f"{what}: {got} differs from {want}")


def small_merge(device, fixtures: Fixtures, reads=SMALL) -> None:
    """The port on `device` against the numpy reference: the two merged
    files must be byte-identical.  Three read blocks, so the blocks'
    overlapped copies and their stream merge run too."""
    import bwtmerge_tpu_torch as port

    a_path, b_path = fixtures.get("small_a"), fixtures.get("small_b")
    d = os.path.dirname(a_path)
    out_port = os.path.join(d, "merged_port.sga")
    out_ref = os.path.join(d, "merged_ref.sga")
    t0 = time.monotonic()
    port.merge_fmi_to_file(port.load_fmi(a_path, "sga"),
                           port.load_fmi(b_path, "sga"), out_port, "sga",
                           port.MergeConfig(device=str(device), temp_dir=d,
                                            device_blocks=3))
    t1 = time.monotonic()
    numpy_fold([a_path, b_path], out_ref)
    t2 = time.monotonic()
    same_bytes(out_port, out_ref, "small merge")
    log(f"small merge {reads[0]}+{reads[1]} reads: byte-identical "
        f"(port {t1 - t0:.3f} s, numpy reference {t2 - t1:.3f} s)")


def small_trie(device, fixtures: Fixtures, reads=SMALL) -> None:
    """The pair of small_merge by the trie search on `device`, in two
    sequence blocks, with the streamed steps and with the gather steps:
    each file byte-identical to the numpy reference's and to the walk's
    (both written by small_merge)."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch import kernels

    a_path, b_path = fixtures.get("small_a"), fixtures.get("small_b")
    d = os.path.dirname(a_path)
    a, b = port.load_fmi(a_path, "sga"), port.load_fmi(b_path, "sga")
    took = {}
    for streamed in (True, False):
        out = os.path.join(d, f"merged_trie_{int(streamed)}.sga")
        before = kernels.launches()["streamed_probe"]
        t0 = time.monotonic()
        port.merge_fmi_to_file(a, b, out, "sga", port.MergeConfig(
            device=str(device), temp_dir=d, search="trie", device_blocks=2,
            streamed=streamed))
        took[streamed] = time.monotonic() - t0
        probes = kernels.launches()["streamed_probe"] - before
        if streamed and probes < 2 * (READ_LEN + 1):
            raise AssertionError(f"small trie merge: {probes} probe launches "
                                 f"in two blocks of {READ_LEN + 1} depths")
        if not streamed and probes:
            raise AssertionError("small trie merge: the gather steps launched "
                                 "the probe kernel")
        same_bytes(out, os.path.join(d, "merged_ref.sga"), "small trie merge")
        same_bytes(out, os.path.join(d, "merged_port.sga"),
                   "small trie merge against the walk")
    log(f"small trie merge {reads[0]}+{reads[1]} reads, two blocks: "
        f"byte-identical to the numpy reference and to the walk (streamed "
        f"{took[True]:.3f} s, gathers {took[False]:.3f} s)")


def long_read_fold(device, fixtures: Fixtures) -> None:
    """Three pieces, the second with a read of LONG_READ characters: the
    fold's decode meets the walk's cap and the inputs go through the
    pairwise chain on the trie search; byte-identical to numpy_fold."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch import kernels

    paths = [fixtures.get(f"fold_long_{k}") for k in range(len(LONG_FOLD))]
    d = os.path.dirname(paths[0])
    out_port = os.path.join(d, "folded_port.sga")
    out_ref = os.path.join(d, "folded_ref.sga")
    before = kernels.launches()["streamed_probe"]
    err = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err):
        port.merge_files_many(paths, out_port, "sga", "sga",
                              port.MergeConfig(device=str(device), temp_dir=d))
    t1 = time.monotonic()
    probes = kernels.launches()["streamed_probe"] - before
    sys.stdout.write(err.getvalue())
    if "falling back to the pairwise chain" not in err.getvalue():
        raise AssertionError("long-read fold: the fold did not leave for the "
                             "pairwise chain")
    if probes < 2 * LONG_READ:
        raise AssertionError(f"long-read fold: {probes} probe launches for a "
                             f"read of {LONG_READ} characters")
    numpy_fold(paths, out_ref)
    t2 = time.monotonic()
    same_bytes(out_port, out_ref, "long-read fold")
    log(f"long-read fold {'+'.join(str(m) for m, _ in LONG_FOLD)} reads, one "
        f"of {LONG_READ} characters: chain on the trie search, "
        f"byte-identical ({probes} probe launches, port {t1 - t0:.3f} s, "
        f"{(t1 - t0) / LONG_READ * 1e3:.3f} ms a depth; numpy reference "
        f"{t2 - t1:.3f} s)")


def small_fold(device, fixtures: Fixtures) -> None:
    """The port's k-way fold of four pieces on `device` (the thread chain,
    lane blocking forced on step 2) against the numpy reference's left
    fold of pairwise merges: the files must be byte-identical."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.ops import kfold_torch

    paths = [fixtures.get(f"fold_small_{k}") for k in range(len(FOLD_SMALL))]
    d = os.path.dirname(paths[0])
    out_port = os.path.join(d, "folded_port.sga")
    out_ref = os.path.join(d, "folded_ref.sga")
    plain = kfold_torch.summed_part_thunks
    blocks = []

    def blocked_on_step_2(targets, creads):
        if len(targets) != 2:
            return plain(targets, creads)
        saved = kfold_torch.MAX_WALK_LANES
        # a budget of a sixth of the reads: eight lane blocks
        kfold_torch.MAX_WALK_LANES = creads.shape[0] * (creads.shape[1] // 6)
        try:
            thunks = plain(targets, creads)
        finally:
            kfold_torch.MAX_WALK_LANES = saved
        blocks.append(len(thunks))
        return thunks

    t0 = time.monotonic()
    kfold_torch.summed_part_thunks = blocked_on_step_2
    try:
        port.merge_files_many(paths, out_port, "sga", "sga",
                              port.MergeConfig(device=str(device), temp_dir=d),
                              chain="threads")
    finally:
        kfold_torch.summed_part_thunks = plain
    t1 = time.monotonic()
    if len(blocks) != 1 or blocks[0] < 2:
        raise AssertionError(f"small fold: step 2 was not lane-blocked "
                             f"({blocks})")
    numpy_fold(paths, out_ref)
    t2 = time.monotonic()
    same_bytes(out_port, out_ref, "small fold")
    log(f"small fold {'+'.join(str(m) for m, _ in FOLD_SMALL)} reads, step 2 "
        f"in {blocks[0]} lane blocks: byte-identical (port {t1 - t0:.3f} s, "
        f"numpy reference left fold {t2 - t1:.3f} s)")


# pinned host bytes of the rank array's blocks: alive now, and the most
# alive at once since the last reset (run_cli resets it)
PINNED = {"live": 0, "bytes": 0}


def count_pinned_blocks() -> None:
    """Wrap ops/ra_stream.Block so that every block adds the bytes of its
    pinned host tensors to PINNED["live"] while they exist, and PINNED
    ["bytes"] keeps the peak.  Blocks a BlockedRA holds live until the
    stream ends; a block it drains to the spill ladder is freed once
    drained."""
    import threading
    import weakref

    from bwtmerge_tpu_torch.ops import ra_stream

    plain = ra_stream.Block.__init__
    lock = threading.Lock()

    def release(n):
        with lock:
            PINNED["live"] -= n

    def counting(self, values, counts):
        plain(self, values, counts)
        for t in (self.values, self.counts):
            if t.is_pinned():
                n = t.numel() * t.element_size()
                with lock:
                    PINNED["live"] += n
                    PINNED["bytes"] = max(PINNED["bytes"], PINNED["live"])
                weakref.finalize(t, release, n)

    ra_stream.Block.__init__ = counting


def drive(fn) -> tuple:
    """fn() with the kernels' launch counts set to 0 just before and read
    just after: (fn's result, launches, wall seconds)."""
    import gc

    from bwtmerge_tpu_torch import kernels

    gc.collect()                 # blocks of earlier phases free their pins
    kernels.reset_launches()
    PINNED["bytes"] = PINNED["live"]
    t0 = time.monotonic()
    out = fn()
    return out, kernels.launches(), time.monotonic() - t0


def run_cli(argv, cli: str = "bwt_merge") -> tuple:
    """The CLI's main(argv) with its output captured and echoed; the
    kernels' launch counts are set to 0 just before and read just after.
    (exit status, stdout, stderr, launches, wall seconds)"""
    import importlib

    main_fn = importlib.import_module(f"bwtmerge_tpu_torch.cli.{cli}").main
    buf_out, buf_err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf_out), contextlib.redirect_stderr(buf_err):
        rc, counts, wall = drive(lambda: main_fn(argv))
    sys.stdout.write(buf_out.getvalue())
    sys.stdout.write(buf_err.getvalue())
    return rc, buf_out.getvalue(), buf_err.getvalue(), counts, wall


def phase_times(err: str) -> dict:
    return {k: float(v) for k, v in re.findall(
        r"bwt_merge: (.+?) finished in ([0-9.]+) seconds", err)}


def main_path(device, fixtures: Fixtures, reads=MEDIUM,
              n_patterns=N_PATTERNS, search: str = "auto",
              walk_launches=None) -> dict:
    """bwt_merge A B out -v patterns [--search trie] on `device`; checks and
    phase times.  The trie run (given the walk run's launch counts) must
    give the walk run's output file byte for byte."""
    from bwtmerge_tpu_torch.formats import read_bwt

    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    pat_path = os.path.join(d, f"patterns_{n_patterns}.txt")
    if not os.path.exists(pat_path):
        write_patterns(pat_path, [reads_of(reads[0], 1),
                                  reads_of(reads[1], 2)], n_patterns, 3)
    log(f"medium fixtures ready {time.monotonic() - fixtures.t0:.1f} s "
        f"after the pool started")
    out = os.path.join(d, "merged.sga" if search == "auto"
                       else f"merged_{search}.sga")
    rc, std, err, counts, wall = run_cli(
        [a_path, b_path, out, "-i", "sga", "-o", "sga", "-v", pat_path,
         "--device", str(device), "--search", search])
    if rc != 0:
        raise AssertionError(f"bwt_merge --search {search} exited {rc}")

    a_runs, _, _ = read_bwt(a_path, "sga")
    b_runs, _, _ = read_bwt(b_path, "sga")
    m_runs, _, _ = read_bwt(out, "sga")
    want = a_runs.counts(6) + b_runs.counts(6)
    if not np.array_equal(m_runs.counts(6), want):
        raise AssertionError("merged symbol counts differ from A + B")
    if search == "trie":
        same_bytes(out, os.path.join(d, "merged.sga"),
                   "main path, trie against the walk")
        # beyond the -v passes (the walk run's count): three probes a range
        # depth, two a singles depth
        extra = counts["streamed_probe"] - walk_launches["streamed_probe"]
        if extra < 2 * (READ_LEN + 1) or counts["walk_emit"] \
                or counts["walk_planes_build"]:
            raise AssertionError(
                f"trie main path: {extra} probe launches beyond the walk "
                f"run's, needs {2 * (READ_LEN + 1)}; launches {counts}")
    elif min(counts["streamed_probe"], counts["walk_emit"],
             counts["walk_planes_build"]) < 1 or counts["decode"]:
        raise AssertionError(f"the two-input main path launched {counts}: "
                             f"needs K1, K2 and walk_planes_build, and no "
                             f"decode")

    phases = phase_times(err)
    b_bases = b_runs.size()
    merge_s = (phases.get("search (rank array)", 0)
               + phases.get("merge (interleave)", 0))
    if not PINNED["bytes"]:
        raise AssertionError("the main path held no pinned rank-array block")
    result = {"launches": counts, "phases_s": phases,
              "verify_s": verify_times(std), "wall_s": wall,
              "b_bases": b_bases,
              "ra_pinned_host_bytes": PINNED["bytes"],
              "ra_pinned_bytes_per_b_position": PINNED["bytes"] / b_bases,
              "merge_mbases_s": b_bases / 1e6 / max(merge_s, 1e-9)}
    log(f"main path (--search {search}) {reads[0]}+{reads[1]} reads, "
        f"{n_patterns} patterns: {json.dumps(result)}")
    return result


def trie_depths(device, fixtures: Fixtures) -> dict:
    """The trie search alone on the medium pair, in the merge's blocks:
    seconds and milliseconds a depth with the streamed steps and with the
    gather steps (each run twice, the second timed), the two rank arrays
    equal; then the streamed search under torch.profiler, for the device
    time in the probe kernel, in sorts and in everything else."""
    import torch

    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.models.merge import AUTO_BLOCKS_MIN_BASES
    from bwtmerge_tpu_torch.ops.search_torch import blocked_search

    a = port.load_fmi(fixtures.get("a"), "sga")
    b = port.load_fmi(fixtures.get("b"), "sga")
    ai, bi = a.device_index(device), b.device_index(device)
    n_blocks = 2 if b.size() >= AUTO_BLOCKS_MIN_BASES else 1
    depths = n_blocks * (READ_LEN + 1)

    def search(streamed):
        ra = blocked_search(ai, bi, a.sequences(), b.sequences(), n_blocks,
                            streamed)
        torch.cuda.synchronize(device)
        return ra

    result = {"blocks": n_blocks, "depths": depths}
    arrays = {}
    for streamed in (True, False, False, True):
        search(streamed)                                  # warm-up
        t0 = time.monotonic()
        ra = search(streamed)
        took = time.monotonic() - t0
        key = "streamed" if streamed else "gathers"
        result.setdefault(f"{key}_s", []).append(took)
        arrays[key] = ra.finish()
    if not all(np.array_equal(x, y) for x, y in zip(arrays["streamed"],
                                                    arrays["gathers"])):
        raise AssertionError("trie search: the streamed and the gather "
                             "steps gave different rank arrays")
    for key in ("streamed", "gathers"):
        result[f"{key}_ms_per_depth"] = min(result[f"{key}_s"]) / depths * 1e3

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        search(True)
    by = {"probe": 0.0, "sort": 0.0, "other": 0.0}
    kernels_ms = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue        # an operator's row repeats its kernels' time
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        name = ev.key.lower()
        kernels_ms.append((us / 1e3, ev.count, ev.key[:72]))
        if "streamed_probe" in name:
            by["probe"] += us
        elif "sort" in name or "radix" in name:
            by["sort"] += us
        else:
            by["other"] += us
    total = sum(by.values())
    # a profiler that traced nothing on the card leaves the shares unmeasured
    result["device_ms_by_kind"] = ({k: v / 1e3 for k, v in by.items()}
                                   if total > 0 else None)
    result["top_device_ms_calls_name"] = sorted(kernels_ms, reverse=True)[:8]
    log(f"trie search alone, medium pair: {json.dumps(result)}")
    return result


def verify_times(out: str) -> list:
    return [float(s) for s in re.findall(
        r"patterns, \d+ occurrences \(([0-9.]+) s", out)]


def fold_path(device, fixtures: Fixtures, n_patterns=N_PATTERNS) -> dict:
    """bwt_merge P0 P1 P2 P3 out -v patterns on `device`: the k-way fold.
    Checks the exit status, the merged symbol counts and the launches."""
    from bwtmerge_tpu_torch.formats import read_bwt

    paths = [fixtures.get(k) for k in ("a", "b", "p2", "p3")]
    d = os.path.dirname(paths[2])
    sources = [(MEDIUM[0], 1), (MEDIUM[1], 2), *FOLD_EXTRA]
    pat_path = os.path.join(d, f"patterns_{n_patterns}.txt")
    if not os.path.exists(pat_path):
        write_patterns(pat_path, [reads_of(m, seed) for m, seed in sources],
                       n_patterns, 6)
    log(f"fold fixtures ready {time.monotonic() - fixtures.t0:.1f} s after "
        f"the pool started")
    out = os.path.join(d, "folded.sga")
    rc, std, err, counts, wall = run_cli(
        [*paths, out, "-i", "sga", "-o", "sga", "-v", pat_path,
         "--device", str(device)])
    if rc != 0:
        raise AssertionError(f"bwt_merge (k-way fold) exited {rc}")

    pieces = [read_bwt(p, "sga")[0] for p in paths]
    m_runs, _, _ = read_bwt(out, "sga")
    if not np.array_equal(m_runs.counts(6),
                          np.sum([p.counts(6) for p in pieces], axis=0)):
        raise AssertionError("folded symbol counts differ from the pieces' "
                             "sum")
    want = {"streamed_probe": 1, "walk_emit": 6, "walk_planes_build": 3,
            "decode": 3, "decode_rows_build": 3}
    if any(counts[k] < n for k, n in want.items()):
        raise AssertionError(f"k-way fold launched {counts}, needs at least "
                             f"{want}")
    rate = re.search(r"one k-way fold: ([0-9.]+) MB/s", std)
    result = {"launches": counts, "phases_s": phase_times(err),
              "verify_s": verify_times(std), "wall_s": wall,
              "bases": int(m_runs.size()),
              "added_bases": int(m_runs.size() - pieces[0].size()),
              "fold_mb_s": float(rate.group(1)) if rate else None,
              "steps": re.findall(r"kfold: (.+?)\n", err)}
    log(f"k-way fold main path, pieces "
        f"{'+'.join(str(m) for m, _ in sources)} reads, {n_patterns} "
        f"patterns: {json.dumps(result)}")
    return result


# -- construction, the interleaves, the CLI gaps --------------------------------


def packed_reads(m: int, seed: int) -> tuple:
    """A fixture's reads as build_from_reads takes them: (flat int32,
    lengths)."""
    return (reads_of(m, seed).astype(np.int32).reshape(-1),
            np.full(m, READ_LEN, np.int64))


@contextlib.contextmanager
def spill_files_made():
    """Within the block, every spill file the rank-array ladder writes is
    listed as (directory, bytes)."""
    from bwtmerge_tpu_torch.models import spill

    made = []
    plain = spill.RankArraySpill._spill

    def counting(self):
        plain(self)
        path = self._files[-1].path
        made.append((os.path.dirname(path), os.path.getsize(path)))

    spill.RankArraySpill._spill = counting
    try:
        yield made
    finally:
        spill.RankArraySpill._spill = plain


def cli_gaps(device, fixtures: Fixtures) -> None:
    """The merge CLI's --backend numpy with a spilling ladder, bwt_convert's
    round trip, bwt_inspect's totals, and the device interleave, all on the
    small pair."""
    import bwtmerge_tpu_torch as port

    a_path, b_path = fixtures.get("small_a"), fixtures.get("small_b")
    d = os.path.dirname(a_path)
    want = os.path.join(d, "merged_port.sga")          # small_merge's
    spill_dir = os.path.join(d, "spill")
    os.makedirs(spill_dir, exist_ok=True)
    out = os.path.join(d, "merged_numpy.sga")
    with spill_files_made() as made:
        rc, _, _, counts, wall = run_cli(
            [a_path, b_path, out, "-i", "sga", "-o", "sga", "--backend",
             "numpy", "-r", "0", "-m", "2", "-b", "0", "-d", spill_dir,
             "--quiet"])
    if rc != 0 or not made or any(x[0] != spill_dir for x in made):
        raise AssertionError(f"--backend numpy: status {rc}, spill files "
                             f"{made}")
    if any(counts.values()) or os.listdir(spill_dir):
        raise AssertionError(f"--backend numpy launched {counts} or left "
                             f"{os.listdir(spill_dir)}")
    same_bytes(out, want, "--backend numpy with a spilled ladder")
    log(f"bwt_merge --backend numpy -r 0 -m 2 -b 0: {len(made)} spill files "
        f"of {sum(x[1] for x in made)} B under -d, byte-identical to the "
        f"device route's ({wall:.3f} s)")

    native = os.path.join(d, "a_converted.native")
    back = os.path.join(d, "a_converted.sga")
    for argv in ([a_path, native, "--quiet"],
                 [native, back, "-i", "native", "-o", "sga", "--quiet"]):
        rc = run_cli(argv, "bwt_convert")[0]
        if rc != 0:
            raise AssertionError(f"bwt_convert {argv} exited {rc}")
    same_bytes(back, a_path, "bwt_convert sga -> native -> sga")
    rc, std, _, _, _ = run_cli([a_path, native, b_path], "bwt_inspect")
    total = re.search(r"Total: (\d+) sequences, (\d+) bases", std)
    want_total = (2 * SMALL[0] + SMALL[1],
                  (2 * SMALL[0] + SMALL[1]) * (READ_LEN + 1))
    if rc != 0 or not total or tuple(map(int, total.groups())) != want_total:
        raise AssertionError(f"bwt_inspect: status {rc}, totals "
                             f"{total and total.groups()} for {want_total}")
    log(f"bwt_convert sga -> native -> sga: byte-identical; bwt_inspect "
        f"totals {want_total[0]} sequences, {want_total[1]} bases")

    out = os.path.join(d, "merged_device_interleave.sga")
    t0 = time.monotonic()
    merged = port.merge_fmi(
        port.load_fmi(a_path, "sga"), port.load_fmi(b_path, "sga"),
        port.MergeConfig(device=str(device), temp_dir=d,
                         interleave="device"))
    port.serialize_fmi(merged, out, "sga")
    same_bytes(out, want, "small merge, device interleave")
    log(f"small merge, interleave='device': byte-identical to the native "
        f"chain's ({time.monotonic() - t0:.3f} s)")


def cli_profile(device, fixtures: Fixtures) -> None:
    """bwt_merge --profile DIR on the small pair: one non-empty Chrome
    trace, the merge's bytes unchanged.  Run last: once a profiler has
    started, its tracing library stays loaded in the process and every
    later launch pays for it."""
    a_path, b_path = fixtures.get("small_a"), fixtures.get("small_b")
    d = os.path.dirname(a_path)
    want = os.path.join(d, "merged_port.sga")          # small_merge's
    prof = os.path.join(d, "profile")
    out = os.path.join(d, "merged_profiled.sga")
    before = set(os.listdir(prof)) if os.path.isdir(prof) else set()
    rc, _, _, _, wall = run_cli([a_path, b_path, out, "-i", "sga", "-o",
                                 "sga", "--device", str(device), "--profile",
                                 prof, "--quiet"])
    traces = sorted(set(os.listdir(prof)) - before)
    sizes = [os.path.getsize(os.path.join(prof, t)) for t in traces]
    if rc != 0 or len(traces) != 1 or sizes[0] < 1000:
        raise AssertionError(f"--profile: status {rc}, traces {traces} of "
                             f"{sizes} B")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    on_card = sum(1 for e in events if e.get("cat") == "kernel")
    same_bytes(out, want, "--profile")
    log(f"bwt_merge --profile: {traces[0]} of {sizes[0]} B, {len(events)} "
        f"events, {on_card} kernels on the card ({wall:.3f} s)")
    for t in traces:
        os.remove(os.path.join(prof, t))


def construction_timing(device, m: int = LARGE_A_READS, seed: int = 1) -> dict:
    """bench.py's large A built on the card.  No numpy build exists at this
    size to compare with, so the cheap facts are checked: symbol counts
    equal the reads', endmarkers the read count."""
    from bwtmerge_tpu_torch.models.build import build_from_reads

    t0 = time.monotonic()
    flat, lengths = packed_reads(m, seed)
    t1 = time.monotonic()
    stats = {}
    runs, order = build_from_reads((flat, lengths), backend="torch",
                                   device=str(device), stats=stats)
    t2 = time.monotonic()
    want = np.bincount(flat, minlength=6)
    want[0] = m
    if not np.array_equal(runs.counts(6), want) or order.size != m:
        raise AssertionError(f"device build of {m} reads: symbol counts "
                             f"{runs.counts(6)} for {want}")
    bases = int(lengths.sum())
    result = {"reads": m, "positions": stats["positions"],
              "rounds": stats["rounds"], "round_s": stats["round_s"],
              "device_s": stats["device_s"], "runs_download_s": stats["runs_s"],
              "build_from_reads_s": t2 - t1, "reads_made_s": t1 - t0,
              "n_runs": runs.n_runs,
              "mbases_s": bases / 1e6 / (t2 - t1),
              "device_mbases_s": bases / 1e6 / stats["device_s"]}
    log(f"construction timing, {m} reads of {READ_LEN} bp on the card: "
        f"{json.dumps(result)}")
    return result


def construction(device, fixtures: Fixtures) -> None:
    """The medium A and B built on the card against the fixtures the numpy
    oracle built (byte-identical SGA files); rlo_order_device against
    rlo_order on the medium A; the bwt_build CLI on the medium B's reads."""
    from bwtmerge_tpu_torch.formats import write_bwt
    from bwtmerge_tpu_torch.models.build import (alphabet_for,
                                                 build_from_reads, rlo_order)
    from bwtmerge_tpu_torch.ops import sa_torch
    from bwtmerge_tpu_torch.utils.alphabet import Alphabet

    d = os.path.dirname(fixtures.get("a"))
    for key, m, seed in (("a", MEDIUM[0], 1), ("b", MEDIUM[1], 2)):
        stats = {}
        t0 = time.monotonic()
        runs, _ = build_from_reads(packed_reads(m, seed), backend="torch",
                                   device=str(device), stats=stats)
        t1 = time.monotonic()
        out = os.path.join(d, f"{key}_device_built.sga")
        write_bwt(out, "sga", runs, alphabet_for(runs))
        same_bytes(out, fixtures.get(key), f"device build of the medium {key}")
        os.remove(out)
        log(f"device build, medium {key.upper()} ({m} reads, "
            f"{stats['positions']} positions): byte-identical to the numpy "
            f"oracle's fixture; {stats['rounds']} rounds "
            f"{[round(x, 4) for x in stats['round_s']]} s, device "
            f"{stats['device_s']:.3f} s, download of the run arrays "
            f"{stats['runs_s']:.3f} s, build_from_reads {t1 - t0:.3f} s "
            f"({m * READ_LEN / 1e6 / (t1 - t0):.1f} Mbases/s)")

    reads = reads_of(MEDIUM[0], 1)
    t0 = time.monotonic()
    got = sa_torch.rlo_order_device(packed_reads(MEDIUM[0], 1), device)
    t1 = time.monotonic()
    want = rlo_order(list(reads))
    t2 = time.monotonic()
    if not np.array_equal(got, want):
        raise AssertionError("rlo_order_device differs from rlo_order on the "
                             "medium A")
    log(f"rlo_order_device, medium A: equal to rlo_order (device "
        f"{t1 - t0:.3f} s with its host key packing, numpy lexsort "
        f"{t2 - t1:.3f} s)")

    reads_path = os.path.join(d, "b_reads.txt")
    chars = Alphabet().comp2char[reads_of(MEDIUM[1], 2).astype(np.uint8)]
    lines = np.full((MEDIUM[1], READ_LEN + 1), 0x0A, np.uint8)
    lines[:, :READ_LEN] = chars
    lines.tofile(reads_path)
    out = os.path.join(d, "b_cli_built.sga")
    rc, std, _, _, wall = run_cli([reads_path, out, "-o", "sga", "--device",
                                   str(device)], "bwt_build")
    if rc != 0:
        raise AssertionError(f"bwt_build exited {rc}")
    same_bytes(out, fixtures.get("b"), "bwt_build of the medium B")
    same_bytes(out + ".reads4", fixtures.get("b") + ".reads4",
               "bwt_build's sidecar of the medium B")
    for path in (reads_path, out, out + ".reads4"):
        os.remove(path)
    log(f"bwt_build CLI, medium B from a plain reads file: output and "
        f"sidecar byte-identical to the fixture's ({wall:.3f} s)")


def medium_interleaves(device, fixtures: Fixtures, workers=(3, 6)) -> dict:
    """The medium merge through the device interleave, and the medium
    pair's rank array through the serial and the range-parallel host
    chains: every file byte-identical to the main path's."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.formats.streaming import write_bwt_stream
    from bwtmerge_tpu_torch.models.merge import _build_ra, _merged_alpha
    from bwtmerge_tpu_torch.models.parallel_merge import (
        interleave_stream_chunks_parallel)
    from bwtmerge_tpu_torch.native import interleave_stream_chunks
    from bwtmerge_tpu_torch.ops import interleave_torch as il
    from bwtmerge_tpu_torch.parallel.distributed import coalesce_run_chunks
    from bwtmerge_tpu_torch.utils.pipeline import prefetch_chunks

    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    want = os.path.join(d, "merged.sga")               # the main path's
    a, b = port.load_fmi(a_path, "sga"), port.load_fmi(b_path, "sga")
    result = {}

    stats = {}
    plain = il.interleave_torch
    il.interleave_torch = lambda *args: plain(*args, stats=stats)
    out = os.path.join(d, "merged_device_interleave.sga")
    t0 = time.monotonic()
    try:
        merged = port.merge_fmi(a, b, port.MergeConfig(
            device=str(device), temp_dir=d, interleave="device"))
    finally:
        il.interleave_torch = plain
    t1 = time.monotonic()
    port.serialize_fmi(merged, out, "sga")
    same_bytes(out, want, "medium merge, device interleave")
    os.remove(out)
    result["device_interleave"] = {
        "merge_fmi_s": t1 - t0, "interleave_decoded_ms":
        stats["interleave_s"] * 1e3, "rle_ms": stats["rle_s"] * 1e3,
        "positions": merged.size(), "runs": merged.runs.n_runs}
    del merged

    config = port.MergeConfig(device=str(device), temp_dir=d).sanitize()
    rv, rc = _build_ra(a, b, config).finish()
    alpha = _merged_alpha(a, b)

    def chunks(step=1 << 20):
        for s in range(0, rv.size, step):
            yield rv[s:s + step], rc[s:s + step]

    def serial():
        return prefetch_chunks(interleave_stream_chunks(
            a.runs, b.runs, prefetch_chunks(chunks(), depth=2)), depth=1)

    chains = {"serial": serial}
    for w in workers:
        chains[f"parallel_{w}"] = lambda w=w: coalesce_run_chunks(
            interleave_stream_chunks_parallel(a.runs, b.runs, chunks(),
                                              workers=w))
    result["host_chains_s"] = {}
    for rep in range(2):
        for name, chain in chains.items():
            out = os.path.join(d, f"merged_{name}.sga")
            t0 = time.monotonic()
            write_bwt_stream(out, "sga", chain(), alpha)
            result["host_chains_s"].setdefault(name, []).append(
                time.monotonic() - t0)
            same_bytes(out, want, f"medium pair, {name} host chain")
            os.remove(out)
    result["ra_runs"] = int(rv.size)
    result["cpu_count"] = os.cpu_count()
    log(f"medium interleaves, all byte-identical to the main path's file: "
        f"{json.dumps(result)}")
    return result


# -- the multi-device paths ---------------------------------------------------------


def p5_spill(device, fixtures: Fixtures, run_buffer: str = "1") -> dict:
    """The medium walk merge with -r 1 -m 2 (a budget of 2 Mi runs) and -d:
    the rank array's blocks past the budget drain into spill files under
    -d, and the output is the main path's, byte for byte.  Once with the
    merge's own blocking (one block of 7.37 M runs: it drains, and the peak
    is that one block) and once in eight read blocks (--device-blocks 8:
    two are held, the rest drain one at a time).  The peak of the pinned
    host bytes alive is printed beside the main path's."""
    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    want = os.path.join(d, "merged.sga")                # the main path's
    spill_dir = os.path.join(d, "spill_p5")
    os.makedirs(spill_dir, exist_ok=True)
    result = {}
    for blocks in (None, 8):
        out = os.path.join(d, "merged_p5.sga")
        argv = [a_path, b_path, out, "-i", "sga", "-o", "sga", "-r",
                run_buffer, "-m", "2", "-d", spill_dir, "--device",
                str(device), "--quiet"]
        if blocks:
            argv += ["--device-blocks", str(blocks)]
        with spill_files_made() as made:
            rc, _, _, counts, wall = run_cli(argv)
        if rc != 0 or not made or os.listdir(spill_dir) \
                or any(x[0] != spill_dir for x in made):
            raise AssertionError(f"-r {run_buffer} -m 2: status {rc}, spill files "
                                 f"{made}, left {os.listdir(spill_dir)}")
        same_bytes(out, want, "-r 1 -m 2 with a spilled rank array")
        os.remove(out)
        result[f"device_blocks_{blocks or 'auto'}"] = {
            "spill_files": len(made), "spill_bytes": sum(x[1] for x in made),
            "peak_pinned_host_bytes": PINNED["bytes"], "wall_s": wall,
            "launches": counts}
    result["main_path_peak_pinned_host_bytes"] = None     # set by main()
    return result


def mesh_routes(device, fixtures: Fixtures, sizes=(2, 4)) -> dict:
    """The medium merge over meshes that repeat the one card, [cuda:0] * 2
    and * 4, through the four routes of models/merge._build_ra_mesh: the
    walk (B has its sidecar), the trie with one sequence block a shard
    (sharded_packed_ra), the trie with 16 blocks (the dynamic queue) and
    the record tables split over the mesh (index_placement='sharded').
    Every file byte-identical to the main path's; the launches of each
    route read just after it.  Then sharded_backward_search on the smoke's
    patterns, its counts equal to the single-device counts."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.ops.rank_torch import batch_count, encode_patterns
    from bwtmerge_tpu_torch.parallel import mesh as pmesh

    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    want = os.path.join(d, "merged.sga")
    a, b = port.load_fmi(a_path, "sga"), port.load_fmi(b_path, "sga")
    routes = {"walk": dict(),
              "trie_one_block_a_shard": dict(search="trie"),
              "trie_dynamic_queue": dict(search="trie", sequence_blocks=16),
              "sharded_index": dict(search="trie",
                                    index_placement="sharded")}
    result = {}
    launches = {}
    shard_stats = {}
    plain = {}
    for fn in ("sharded_walk_packed_ra", "sharded_packed_ra",
               "dynamic_block_search"):
        # each route's per-shard figures, through the stats its function
        # already fills
        plain[fn] = getattr(pmesh, fn)
        setattr(pmesh, fn, lambda *args, _f=plain[fn], **kw:
                _f(*args, stats=shard_stats, **kw))
    for n in sizes:
        mesh = [device] * n
        for name, kw in routes.items():
            kw = dict(kw)
            if name == "trie_one_block_a_shard":
                kw["sequence_blocks"] = n
            out = os.path.join(d, f"merged_mesh_{n}_{name}.sga")
            config = port.MergeConfig(device=str(device), devices=mesh,
                                      temp_dir=d, **kw)
            shard_stats.clear()
            try:
                _, counts, wall = drive(lambda: port.merge_fmi_to_file(
                    a, b, out, "sga", config))
            except BaseException:
                for fn, f in plain.items():
                    setattr(pmesh, fn, f)
                raise
            same_bytes(out, want, f"mesh of {n}, {name}")
            os.remove(out)
            need = {"walk": {"walk_emit": n, "walk_planes_build": 1},
                    "trie_one_block_a_shard": {"streamed_probe": n},
                    "trie_dynamic_queue": {"streamed_probe": n},
                    "sharded_index": {}}[name]
            if device.type == "cuda" and any(counts[k] < v
                                             for k, v in need.items()):
                raise AssertionError(f"mesh of {n}, {name}: launches "
                                     f"{counts}, needs at least {need}")
            launches[f"mesh_{n}_{name}"] = counts
            result[f"mesh_{n}_{name}"] = {
                "search_s": config.timer.phases["search (rank array)"],
                "wall_s": wall, "launches": counts,
                "peak_pinned_host_bytes": PINNED["bytes"],
                **shard_stats}
            log(f"mesh of {n} x {device}, {name}: byte-identical, "
                f"{json.dumps(result[f'mesh_{n}_{name}'])}")
    for fn, f in plain.items():
        setattr(pmesh, fn, f)

    pat_path = os.path.join(d, f"patterns_{N_PATTERNS}.txt")
    with open(pat_path) as f:
        patterns = f.read().split()
    merged = port.load_fmi(want, "sga")
    idx = merged.device_index(device)
    single = batch_count(idx, patterns, merged.alpha.char2comp)
    comps, lens = encode_patterns(patterns, merged.alpha.char2comp)
    for n in sizes:
        got, counts, wall = drive(lambda: pmesh.sharded_backward_search(
            idx, comps, lens, mesh=[device] * n))
        if not np.array_equal(got, single):
            raise AssertionError(f"sharded_backward_search over {n} shards "
                                 f"differs from the single-device counts")
        if device.type == "cuda" and counts["streamed_probe"] < n:
            raise AssertionError(f"sharded_backward_search over {n} shards "
                                 f"launched {counts}")
        launches[f"mesh_{n}_verify"] = counts
        result[f"mesh_{n}_verify"] = {"patterns": len(patterns),
                                      "occurrences": int(got.sum()),
                                      "wall_s": wall, "launches": counts}
    log(f"sharded_backward_search, {len(patterns)} patterns over meshes of "
        f"{sizes}: equal to the single-device counts "
        f"({int(single.sum())} occurrences)")
    result["launches"] = launches
    return result


def cli_t2(device, fixtures: Fixtures) -> dict:
    """bwt_merge -t 2 --device cuda: with one GPU it exits 1 naming the
    count torch sees; with two or more it writes the main path's bytes."""
    import torch

    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    out = os.path.join(d, "merged_t2.sga")
    rc, _, err, counts, wall = run_cli([a_path, b_path, out, "-i", "sga",
                                        "-o", "sga", "-t", "2", "--device",
                                        "cuda", "--quiet"])
    visible = torch.cuda.device_count()
    if visible < 2:
        if rc != 1 or f"torch.cuda.device_count() is {visible}" not in err \
                or os.path.exists(out):
            raise AssertionError(f"-t 2 on {visible} GPU: status {rc}, "
                                 f"stderr {err!r}")
    else:
        if rc != 0:
            raise AssertionError(f"-t 2 on {visible} GPUs exited {rc}")
        same_bytes(out, os.path.join(d, "merged.sga"), "-t 2")
        os.remove(out)
    log(f"bwt_merge -t 2 --device cuda with {visible} GPU(s): status {rc}")
    return {"visible_gpus": visible, "status": rc, "wall_s": wall,
            "launches": counts}


def multihost_worker(rank: int, port_no: int, a_path: str, b_path: str,
                     out_dir: str, device: str) -> None:
    """One rank of the two-process merge (run as `chip_smoke.py
    --multihost-worker ...`): the world forms on gloo over localhost, the
    process searches its half of B on `device`, and writes its fragments
    of the SGA and the native output; one JSON line of its figures."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch import kernels
    from bwtmerge_tpu_torch.parallel.distributed import (
        initialize_multihost, multihost_merge_to_file)

    t0 = time.monotonic()
    initialize_multihost(f"tcp://127.0.0.1:{port_no}", 2, rank,
                         timeout_s=300)
    a, b = port.load_fmi(a_path, "sga"), port.load_fmi(b_path, "sga")
    t1 = time.monotonic()
    figures = {"rank": rank, "world_and_load_s": t1 - t0}
    kernels.reset_launches()
    a.device_index(device), b.device_index(device)
    figures["index_build_s"] = time.monotonic() - t1
    for fmt in ("sga", "native"):
        stats = {}
        t = time.monotonic()
        multihost_merge_to_file(a, b, os.path.join(out_dir, f"merged.{fmt}"),
                                fmt, shard_dir=out_dir, device=device,
                                stats=stats)
        figures[fmt] = {"merge_s": time.monotonic() - t, **stats}
    figures["launches"] = kernels.launches()
    print("MULTIHOST " + json.dumps(figures), flush=True)


def two_processes(device, fixtures: Fixtures, timeout_s: int = 300) -> dict:
    """A torch.distributed world of two processes on the one card (gloo,
    localhost): multihost_merge_to_file of the medium pair into SGA and
    native, each byte-identical to the single-device merge's file."""
    import socket

    import bwtmerge_tpu_torch as port

    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    want_native = os.path.join(d, "merged_single.native")
    port.merge_fmi_to_file(port.load_fmi(a_path, "sga"),
                           port.load_fmi(b_path, "sga"), want_native,
                           "native", port.MergeConfig(device=str(device),
                                                      temp_dir=d))
    out_dir = os.path.join(d, "multihost")
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port_no = sk.getsockname()[1]
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(rank), str(port_no), a_path, b_path, out_dir, str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"multihost worker exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    figures = [json.loads(line.split(" ", 1)[1]) for text in logs
               for line in text.splitlines() if line.startswith("MULTIHOST ")]
    same_bytes(os.path.join(out_dir, "merged.sga"),
               os.path.join(d, "merged.sga"), "two-process merge, SGA")
    same_bytes(os.path.join(out_dir, "merged.native"), want_native,
               "two-process merge, native")
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    os.remove(want_native)
    result = {"wall_s": wall, "processes": figures}
    log(f"two processes on gloo, each on {device}: SGA and native "
        f"byte-identical to the single-device merge's; {json.dumps(result)}")
    return result


def sharded_build(device, shards: int = 4, reads: int = MEDIUM[0]) -> dict:
    """build_bwt_sharded of the medium A over [cuda:0] * 4, byte-identical
    to build_from_reads(backend='torch') on the card; both timed."""
    from bwtmerge_tpu_torch.formats import write_bwt
    from bwtmerge_tpu_torch.models.build import alphabet_for, build_from_reads
    from bwtmerge_tpu_torch.parallel.sort_distributed import build_bwt_sharded

    packed = packed_reads(reads, 1)
    d = os.path.join(CACHE, "sharded_build")
    os.makedirs(d, exist_ok=True)
    t0 = time.monotonic()
    single, _ = build_from_reads(packed, backend="torch", device=str(device))
    t1 = time.monotonic()
    runs, counts, wall = drive(lambda: build_bwt_sharded(
        packed, mesh=[device] * shards))
    paths = []
    for name, r in (("single", single), ("sharded", runs)):
        paths.append(os.path.join(d, f"a_{name}.sga"))
        write_bwt(paths[-1], "sga", r, alphabet_for(r))
    same_bytes(paths[1], paths[0], "sharded build of the medium A")
    for path in paths:
        os.remove(path)
    result = {"reads": reads, "shards": shards,
              "positions": int(runs.size()), "sharded_s": wall,
              "single_device_s": t1 - t0, "launches": counts}
    log(f"build_bwt_sharded, medium A over {shards} x {device}: "
        f"byte-identical to the single-device build; {json.dumps(result)}")
    return result


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--multihost-worker":
        sys.path.insert(0, ROOT)
        rank, port_no, a_path, b_path, out_dir, dev = sys.argv[2:8]
        multihost_worker(int(rank), int(port_no), a_path, b_path, out_dir,
                         dev)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    import bwtmerge_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    t0 = time.monotonic()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    builds = build_all()
    log(f"build: kernels {builds['kernels_s']:.2f} s, native host library "
        f"{builds['native_s']:.2f} s")
    count_pinned_blocks()
    with Fixtures() as fixtures:
        measure_copy_rate(device)
        records = check_kernels(device, K1_POSITIONS, K1_QUERIES,
                                K1_SENTINELS, K2_SHAPE)
        records += check_decode(device, fixtures.get("k3"))
        small_merge(device, fixtures)
        small_fold(device, fixtures)
        small_trie(device, fixtures)
        long_read_fold(device, fixtures)
        kernel_times(device, fixtures)
        paths = {"two_input_merge": main_path(device, fixtures),
                 "kway_fold": fold_path(device, fixtures)}
        paths["trie_merge"] = main_path(
            device, fixtures, search="trie",
            walk_launches=paths["two_input_merge"]["launches"])
        trie_depths(device, fixtures)
        # the later slices' phases come after the main paths, which so run
        # in the process state they always had
        cli_gaps(device, fixtures)
        construction_timing(device)
        construction(device, fixtures)
        medium_interleaves(device, fixtures)
        # the multi-device paths, on meshes that repeat the one card
        p5 = p5_spill(device, fixtures)
        p5["main_path_peak_pinned_host_bytes"] = \
            paths["two_input_merge"]["ra_pinned_host_bytes"]
        log(f"rank-array budget (-r 1 -m 2): {json.dumps(p5)}")
        for key in ("device_blocks_auto", "device_blocks_8"):
            paths[f"p5_{key}"] = p5[key]
        mesh = mesh_routes(device, fixtures)
        for key, counts in mesh.pop("launches").items():
            paths[key] = {"launches": counts}
        t2 = cli_t2(device, fixtures)
        paths["cli_t2"] = t2
        for fig in two_processes(device, fixtures)["processes"]:
            paths[f"two_process_rank_{fig['rank']}"] = fig
        paths["sharded_build"] = sharded_build(device)
        # what one card cannot show: -t 2 is the only run that puts shards
        # on two GPUs (peer copies of the index), and NCCL never ran
        log(json.dumps({"multi_gpu": {
            "visible_gpus": t2["visible_gpus"],
            "peer_copies": t2["visible_gpus"] >= 2, "nccl": False}}))
        cli_profile(device, fixtures)
    for rec in records:
        by_path = {k: r["launches"][rec["name"]] for k, r in paths.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "bwtmerge_tpu"))
    if foreign:
        raise AssertionError(f"chip_smoke imported {foreign}")
    log(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
