#!/usr/bin/env python3
"""Drive the PyTorch port (bwtmerge_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --search-split N   # only the large walk merges'
                                             # search phases, N times each
    python3 chip_smoke.py --pass-split N     # only large-walk-v's and
                                             # large-trie's passes, split,
                                             # N times each
    python3 chip_smoke.py --probe            # only K1's forms, at random
                                             # keys and at a -v count's

Phases, in order; any failure raises and the script exits non-zero:

1. card: the card's name and power limit, from nvidia-smi;
2. build: the CUDA kernels (csrc/*.cu, one nvcc each, in parallel) and the
   native host library; then every fixture starts building in a pool of
   worker processes, overlapping the phases below;
3. kernels: each kernel against its plain PyTorch version on the card,
   compared for exact equality (all integer) and timed with CUDA events:
   K1 and K2 at the main path's shapes, K1 in each of its three forms
   (full, select, also fused with the sort's permutation, and lf; timed
   on the device by CUDA graph replay and through the wrapper) also at
   the trie search's batches (sorted, with many equal neighbours, ending
   in queries equal to the size), K2 also with every lane starting at a
   super-block's edge or at the table's last position, K3
   (the read decode) on the real BWT of 10^6 reads of 1..24 characters
   plus one of 100, past the 64-row cap, with lanes starting at block
   offsets 0 and 31; the full decode must also give back the generated
   reads.  The kernels that build K2's and K3's tables (walk_planes_build,
   decode_rows_build) are held against their plain versions on the same
   record tables, decode_rows_build also on tables of symbols 0..6 at 1,
   31, 32, 33, 255, 256, 257, 1023, 1025, 1026 and 2^22 + 5 blocks.
   rec_build, the record table's build, is held against
   build_rec_plain at the medium A's size (26.7 M random positions) with a
   zero and a random base, and at 1, 255, 256, 257, 1023, 1024, 1025,
   2049 and 2^20 + 3 blocks, and timed beside torch.cumsum over the
   transposed [8, NBLK] counts.
   Each kernel's bound is computed from these inputs;
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

Then bench.py's large scale and the record build at the layout's limit:

13b. the main path at bench.py's large scale: A of 2,000,000 and B of
    1,000,000 random 50 bp reads (bench.py's seeds 101 and 102; B with its
    sidecar) built on the card by build_from_reads and cached;
    bwt_merge A B out -v patterns --device-blocks 8 -r 3 -m 2 -d DIR (6 Mi
    runs held, bench.py's spill threshold: the rest drains into several
    spill files), byte-identical to the same merge without the budget and
    to the --search trie merge; rec_build launched once a record table
    built in each run; phases, -v passes, index builds, Mbases/s, spill
    files.  The unspilled walk merge counts large-walk-v's own -v file
    (2^21 32-mers): K1 launched exactly 93 times, 31 a count, as its 2^21
    rows are one chunk under rank_torch.count_chunk_rows' default budget,
    and a line before the run's splits each count into the patterns'
    encoding, its index's build on the card and the search; once the run
    is over, the same patterns are counted again at chunks of 2^16, 2^18
    and 2^21 rows, each in a window of its own (search time, K1 launches,
    peak device memory, the run's counts); then K1 at
    the count's shape (both range ends of 2^21 patterns, every step's
    sorted keys, characters and permutation over the large A): the
    select form as the count launches it and the full form against their
    plain versions, timed with their bounds beside the select form
    without the fusion; a line after each walk
    merge splits its search phase (search_split: B's sidecar read, its
    layout, the gate's composition count, index build and spot walk, A's
    index, the planes, the walk and its copies, the primed stream).  Then
    the large A's
    table by rec_build and by build_rec_plain: time and the peak of
    device memory above the nibbles; the large B's decode rows by
    decode_rows_build against its plain version, timed.  Then one pass
    each of large-walk-v and large-trie without -v (the bench's
    arguments), split by pass_split: A's and B's loads, the search, merge
    and index build phases, the run counts inside write_bwt, the SGA
    writer and the rest;
13c. rec_build at 2^31 - 2 random positions (the largest index the int32
    layout takes), checked without the plain version's scan: row 0 is the
    base, neighbouring rows differ by the block counts and the packed
    words are the plain packing (torch ops, slab by slab), the last row
    plus its block's counts is the base plus the text's bincount; then
    decode_rows_build over that table, checked on 2^20 random rows and
    the first and last 4,096 against the plain version run on those
    rows' records, and timed;
13d. the xlarge tier (bwtmerge_tpu_torch/xlarge/), its base cut from six
    folds to three for the script's time: the fixtures built on the card
    from a cold cache (.smoke_cache/xl/: pieces of 2,000,000 random 50 bp
    reads with sidecars, seeds 201-204, 208 and 209, and a 408 Mbp base of
    piece 201 and three merge_fmi folds), then the 3-way fold of the base
    and pieces 209 and 208 into 612 Mbp by xlarge.bench.run: the output's
    size the inputs' sum, and the counts of 4,096 read-derived 32-mers and
    of 2^18 patterns (through batch_count: K1) the inputs' sums; the
    each kernel of the fold held against its plain version on the same
    card tensors at the fold's shapes (rec_build over the base, piece 209
    and the output; walk_planes_build over the base and the piece; K3 and
    decode_rows_build over the piece's 2,000,000 reads; K2 walking them
    through the base's and the piece's planes; K1's forms with 2^17 sorted
    queries on the output's table); the output byte-identical to the pairwise
    route's (merge_files of the base and piece 209, then of that and piece
    208); launches, phases, per-step drain times, peak host RSS and peak
    device memory of each part;

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
    device; rec_build once a slab of the split tables), per-shard runs
    and search seconds; sharded_backward_search
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
18b. the port's benchmark (bwtmerge_tpu_torch/bench.py): its
    large-trie cell through bench.main with one timed pass; the line must
    say correct: true (the output equal to the BWT that the bench's numpy
    reference sorts from the concatenated reads);
19. bwt_merge --profile DIR on the small pair must leave one non-empty
    trace and the small merge's bytes (last but one: a profiler, once
    started, leaves its tracing library loaded, and later launches pay for
    it);
20. the table builders' profile: rec_build at the medium A's size, the
    large A's and 2^31 - 2 positions, walk_planes_build over 100 M
    positions, and decode_rows_build at K3's piece (421,957 blocks), the
    large B's size (51 M positions) and 2^31 - 2 positions, each timed
    with CUDA events and then under torch.profiler
    (each kernel's device time a call and its share); their sources
    compiled again with -Xptxas -v (registers, spills, shared memory) and
    read back with cuobjdump -sass (static instruction counts, popcounts,
    shuffles), whence each builder's instructions a record block, written
    into their records of the kernels' JSON line; and a read-only probe
    kernel that reads the symbol half of every 64-byte record of a 1 GiB
    table, against one that reads the whole records.

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
import filecmp
import io
import multiprocessing
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from bwtmerge_tpu_torch.bench import (CELLS, PATTERN_LEN,
                                      device_us_by_kernel, indexes_built,
                                      kernel_name, phase_times,
                                      spill_files_made, verify_times,
                                      write_patterns)

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


def time_ms_graph(fn, device, iters: int = 20) -> float:
    """Mean device milliseconds per call of fn, with no host time between
    calls: `iters` calls captured in one CUDA graph, replayed once to warm
    up and timed by CUDA events over three replays.  A small launch, whose
    wrapper takes longer on the host than its kernel on the card, is timed
    here at its kernel's own speed (time_ms there measures the host)."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, device, iters)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


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


def probe_bound(rec, q, size: int, form: str = "full", chars=None,
                perm=None) -> dict:
    """K1's bound for one form on these keys: every key read (4 B), and for
    the select form each live key's character (its dtype's bytes; a key
    past the size reads none) and every key's entry of the sort's
    permutation where it is given (8 B); the form's output written
    once (full: the 8 ranks and the symbol, 36 B; select: one rank, 4 B;
    lf: the symbol and its rank, 8 B); each record that some live key
    falls in read once (64 B; keys past the size touch none).  Operations:
    a compare and an add per position of the block and character counted,
    8 characters for full, 1 for select and lf.  bound_ms_with_zero_rows
    is the bound of the kernel before it had forms, which stored 16 rows a
    key whatever its caller read and counted all 8 characters: what its
    earlier times were held against."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import BLK, LANES

    live = q[q <= size]
    blocks = int(torch.unique_consecutive(live >> 5).numel())
    n_live = int(live.numel())
    records = blocks * rec.shape[1] * 4
    per_key = 4 + PROBE_OUT_BYTES[form] + (0 if perm is None else 8)
    chars_read = 0 if chars is None else n_live * chars.element_size()
    out = bound(q.numel() * per_key + chars_read + records,
                n_live * BLK * (LANES if form == "full" else 1) * 2)
    out["bound_ms_with_zero_rows"] = bound(
        q.numel() * (4 + 4 * 16) + records, n_live * BLK * LANES * 2
    )["bound_ms"]
    return out


PROBE_OUT_BYTES = {"full": 36, "select": 4, "lf": 8}   # K1's output a key
K1_RECORD = {"route": "cuda",
             "source": "bwtmerge_tpu_torch/csrc/streamed_probe.cu",
             "replaces": "bwtmerge_tpu/ops/rank_pallas.py:58"}


def probe_forms(rec, q, size: int, chars, perm) -> dict:
    """K1's forms on the sorted keys q: {form: (kernel call, plain call,
    bound)}.  chars (one a key) and perm (the permutation that sorted the
    keys) feed the select form: "select" takes the characters beside the
    sorted keys, as the trie's singles step does; "select_fused" takes
    them in the caller's order with perm and writes each rank back there,
    as a -v count's step does."""
    from bwtmerge_tpu_torch.ops import rank_streamed as rs

    beside = chars[perm]
    return {
        "full": (lambda: rs.streamed_probe(rec, q, size),
                 lambda: rs.streamed_probe_plain(rec, q, size),
                 probe_bound(rec, q, size)),
        "select": (lambda: rs.streamed_select(rec, q, beside, size),
                   lambda: rs.streamed_select_plain(rec, q, beside, size),
                   probe_bound(rec, q, size, "select", beside)),
        "select_fused": (
            lambda: rs.streamed_select(rec, q, chars, size, perm),
            lambda: rs.streamed_select_plain(rec, q, chars, size, perm),
            probe_bound(rec, q, size, "select", chars, perm)),
        "lf": (lambda: rs.streamed_lf(rec, q, size),
               lambda: rs.streamed_lf_plain(rec, q, size),
               probe_bound(rec, q, size, "lf")),
    }


def held_equal(what: str, kernel, plain, device) -> int:
    """kernel() against plain(), exact; the max abs error (0), or raise."""
    import torch

    got, want = kernel(), plain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{what} differs from its plain version (max "
                             f"abs err {err})")
    return err


def check_probe(device, rec, q, size: int, chars, perm,
                plain_iters: int = 20) -> dict:
    """Each of K1's forms on the sorted keys q against its plain version,
    exact, then timed: {form: record}, with each form's bound.  ms is the
    kernel's device time (time_ms_graph), wrapper_ms a call through its
    wrapper as a caller makes it (time_ms: the host's time where that is
    longer), plain_ms the plain version's."""
    out = {}
    for form, (kernel, plain, bnd) in probe_forms(rec, q, size, chars,
                                                  perm).items():
        out[form] = {
            "max_abs_err": held_equal(f"K1's {form} form at {q.numel()} "
                                      f"keys", kernel, plain, device),
            "ms": time_ms_graph(kernel, device),
            "wrapper_ms": time_ms(kernel, device),
            "plain_ms": time_ms(plain, device, plain_iters), **bnd}
        out[form]["share_of_bound"] = out[form]["bound_ms"] / out[form]["ms"]
    return out


def probe_batch(n_pos: int, n_q: int, n_sent: int, gen, device):
    """n_q sorted random keys in [0, n_pos], the last equal to n_pos, then
    n_sent 2^31-1 sentinels; characters 0..7 in a random caller's order
    and the permutation that sorts that order: (q, chars, perm)."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import LANES

    q = torch.sort(torch.randint(0, n_pos + 1, (n_q,), generator=gen,
                                 device=device)).values
    q[-1] = n_pos                                     # q == size
    q = torch.cat([q, torch.full((n_sent,), 2**31 - 1, device=device,
                                 dtype=q.dtype)]).to(torch.int32)
    chars = torch.randint(0, LANES, (q.numel(),), generator=gen,
                          device=device, dtype=torch.int32)
    perm = torch.randperm(q.numel(), generator=gen, device=device)
    return q, chars, perm


def check_probe_forms(device, idx, gen, n_q: int, n_sent: int) -> list:
    """K1's three forms (full, select, lf; select also fused with the
    sort's permutation) against their plain versions at n_q sorted random
    queries and n_sent sentinels and at the trie search's batches, each
    timed with its bound: the forms' records."""
    import torch

    n_pos = idx.size
    q, chars, perm = probe_batch(n_pos, n_q, n_sent, gen, device)
    at = check_probe(device, idx.rec, q, idx.size, chars, perm)
    records = {form: {"name": f"streamed_probe.{form}", **K1_RECORD,
                      **at[form]} for form in ("full", "select", "lf")}
    records["select"]["fused"] = at["select_fused"]
    for form, rec in at.items():
        log(f"K1 {form}: {n_pos} positions, {n_q} sorted queries + "
            f"{n_sent} sentinels: equal, {rec['ms']:.4f} ms on the card "
            f"({rec['wrapper_ms']:.4f} ms a wrapper call) vs plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['share_of_bound']:.1%}; "
            f"{rec['bound_ms_with_zero_rows']:.4f} ms at 16 rows)")

    # the trie search's batches: a frontier's b_sp at depths 1-3 is sorted
    # with long runs of equal neighbours, and its last b_ep + 1 is the size
    for name, distinct in (("depth-1", 4), ("depth-3", 64),
                           ("singles", n_q // 4)):
        qt = torch.sort(torch.randint(0, n_pos, (distinct,), generator=gen,
                                      device=device)).values
        qt = qt.repeat_interleave(n_q // 4 // distinct)
        qt = torch.cat([qt, torch.full((17,), n_pos, device=device,
                                       dtype=qt.dtype)]).to(torch.int32)
        _, ct, pt = probe_batch(n_pos, qt.numel(), 0, gen, device)
        at = check_probe(device, idx.rec, qt, idx.size, ct, pt, 3)
        for form, got in at.items():
            rec = (records["select"]["fused"] if form == "select_fused"
                   else records[form])
            rec["max_abs_err"] = max(rec["max_abs_err"], got["max_abs_err"])
            rec.setdefault("trie_batches", {})[name] = {
                k: got[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                    "bound_ms", "share_of_bound")}
        log(f"K1, trie {name} batch: {qt.numel()} queries, {distinct} "
            f"distinct + 17 equal to the size: every form equal; "
            + ", ".join(f"{form} {got['ms']:.4f} ms ({got['wrapper_ms']:.4f} "
                        f"a wrapper call; bound {got['bound_ms']:.4f})"
                        for form, got in at.items()))
    return list(records.values())


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


def random_nibbles(n_pos: int, device, seed: int):
    """n_pos random symbols 0..5 made on the device, SIGMA-padded to whole
    blocks: (symbols uint8[n_pos], block-planar nibbles uint8[nblk * 16],
    nblk)."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import BLK, SIGMA

    gen = torch.Generator(device=device).manual_seed(seed)
    syms = torch.randint(0, SIGMA, (n_pos,), generator=gen, device=device,
                         dtype=torch.uint8)
    nblk = n_pos // BLK + 1
    text = torch.full((nblk * BLK,), SIGMA, dtype=torch.uint8, device=device)
    text[:n_pos] = syms
    blocks = text.view(nblk, BLK)
    return syms, (blocks[:, :16] | (blocks[:, 16:] << 4)).reshape(-1), nblk


def random_index(n_pos: int, device, seed: int):
    """A DeviceFMIndex over n_pos random symbols 0..5, built on the device
    from the symbols themselves (a probe needs no valid BWT)."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import (SIGMA, DeviceFMIndex,
                                                   build_rec, c_array)

    syms, nibbles, nblk = random_nibbles(n_pos, device, seed)
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

    from bwtmerge_tpu_torch.ops.rank_torch import BLK
    from bwtmerge_tpu_torch.ops.walk_torch import (NC, SUPER, build_cplanes,
                                                   build_walk_planes,
                                                   build_walk_planes_plain,
                                                   walk_emit, walk_emit_plain)

    idx = random_index(n_pos, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    k1 = check_probe_forms(device, idx, gen, n_q, n_sent)

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
    return k1 + [k2, kb]


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
    from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex

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
    check_decode_rows_edges(device)
    kb = {"name": "decode_rows_build", "route": "cuda",
          "source": "bwtmerge_tpu_torch/csrc/decode.cu",
          "replaces": "bwtmerge_tpu/ops/walk_jax.py:272",
          "max_abs_err": err, "nblk": idx.rec.shape[0],
          "edge_blocks": list(DECODE_EDGE_BLOCKS),
          "ms": time_ms(lambda: build_decode_rows(idx.rec), device),
          "plain_ms": time_ms(lambda: build_decode_rows_plain(idx.rec),
                              device, 5),
          **decode_rows_bound(idx.rec.shape[0])}
    log(f"decode_rows_build: {idx.size} positions, rows {list(rows.shape)}: "
        f"equal, and at {list(DECODE_EDGE_BLOCKS)} blocks; {kb['ms']:.4f} "
        f"ms vs plain {kb['plain_ms']:.4f} ms, bound {kb['bound_ms']:.4f} ms")
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


# decode_rows_build at one block, around a warp's and a thread block's
# blocks (32, 256; one a thread) and four thread blocks' (1024), and at
# 2^22 + 5 blocks
DECODE_EDGE_BLOCKS = (1, 31, 32, 33, 255, 256, 257, 1023, 1025, 1026,
                      (1 << 22) + 5)
DECODE_SAMPLE_ROWS = 1 << 20         # random rows checked at the limit
DECODE_SAMPLE_ENDS = 4096            # and the first and last rows


def decode_rows_bound(nblk: int) -> dict:
    """decode_rows_build's bound: the record table read once (64 B a block)
    and the rows written once (32 B); a shift, a mask and an or per
    position and bit-plane."""
    from bwtmerge_tpu_torch.ops.rank_torch import BLK

    return bound(nblk * 96, nblk * BLK * 3 * 3)


def symbol_records(nblk: int, device, seed: int):
    """A record table of nblk blocks built on the card by rec_build over
    random symbols 0..6 (the first seven positions hold 0..6, so every
    table holds each)."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import BLK, build_rec

    gen = torch.Generator(device=device).manual_seed(seed)
    syms = torch.randint(0, 7, (nblk * BLK,), generator=gen, device=device,
                         dtype=torch.uint8)
    syms[:7] = torch.arange(7, device=device, dtype=torch.uint8)
    blocks = syms.view(nblk, BLK)
    return build_rec((blocks[:, :16] | (blocks[:, 16:] << 4)).reshape(-1),
                     nblk)


def check_decode_rows_edges(device) -> None:
    """decode_rows_build against its plain version, exact, on record tables
    of DECODE_EDGE_BLOCKS blocks."""
    import torch

    from bwtmerge_tpu_torch.ops.decode_torch import (build_decode_rows,
                                                     build_decode_rows_plain)

    for k, nblk in enumerate(DECODE_EDGE_BLOCKS):
        rec = symbol_records(nblk, device, 40 + k)
        got = build_decode_rows(rec)
        want = build_decode_rows_plain(rec)
        torch.cuda.synchronize(device)
        if not torch.equal(got, want):
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            raise AssertionError(f"decode_rows_build differs from its plain "
                                 f"version at {nblk} blocks (max abs err "
                                 f"{err})")


def decode_rows_sampled(device, rec, seed: int) -> dict:
    """decode_rows_build over a whole record table too large for the plain
    version, checked on DECODE_SAMPLE_ROWS random rows and the first and
    last DECODE_SAMPLE_ENDS, against the plain version run on those rows'
    records (a row depends on its own record alone).  Time and bound."""
    import torch

    from bwtmerge_tpu_torch.ops.decode_torch import (build_decode_rows,
                                                     build_decode_rows_plain)

    nblk = rec.shape[0]
    rows = build_decode_rows(rec)
    gen = torch.Generator(device=device).manual_seed(seed)
    ends = torch.arange(min(DECODE_SAMPLE_ENDS, nblk), device=device)
    pick = torch.cat([ends, nblk - 1 - ends,
                      torch.randint(0, nblk, (DECODE_SAMPLE_ROWS,),
                                    generator=gen, device=device)])
    got, want = rows[pick], build_decode_rows_plain(rec[pick])
    torch.cuda.synchronize(device)
    if not torch.equal(got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        raise AssertionError(f"decode_rows_build differs from its plain "
                             f"version on the sampled rows of {nblk} "
                             f"blocks (max abs err {err})")
    del rows
    out = {"nblk": nblk, "rows_checked": int(pick.numel()),
           "ms": time_ms(lambda: build_decode_rows(rec), device, 5),
           **decode_rows_bound(nblk)}
    log(f"decode_rows_build, {nblk} blocks, sampled rows equal: "
        f"{json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


# rec_build at one block, the edges of the first design's tile (256) and of
# this design's (1024, REC_TILE), two tiles and one, and 1025 tiles
REC_EDGE_BLOCKS = (1, 255, 256, 257, 1023, 1024, 1025, 2049, (1 << 20) + 3)
REC_LIMIT_POSITIONS = 2**31 - 2      # the largest index the int32 layout takes
REC_CHECK_SLAB = 1 << 22             # blocks a slab of the limit's checks


def rec_bound(nblk: int) -> dict:
    """rec_build's bound: the nibbles read once (16 B a block), the table
    written once (64 B a block) and the base row read; a compare and an
    add per position and occ lane."""
    from bwtmerge_tpu_torch.ops.rank_torch import BLK, LANES

    return bound(nblk * 80 + 4 * LANES, nblk * BLK * LANES * 2)


def check_rec_build(device, n_pos: int = MEDIUM[0] * (READ_LEN + 1),
                    seed: int = 9) -> list:
    """rec_build against build_rec_plain on the same device tensors, exact:
    n_pos random positions (the medium A's size) with a zero base and with
    a random one, then the edge sizes of REC_EDGE_BLOCKS (one block, a
    tile and its neighbours, 2^20 + 3 blocks), each with both bases.  Timed
    beside the plain version and beside the one PyTorch call that does the
    scan part, torch.cumsum over the transposed [LANES, NBLK] counts (the
    port never calls it).  Returns rec_build's record."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import (LANES, block_counts,
                                                   build_rec, build_rec_plain)

    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randint(0, 1 << 24, (LANES,), generator=gen, device=device,
                         dtype=torch.int32)
    err = 0
    cases = [(n_pos, seed)] + [(blocks * 32 - 1 - k, seed + 1 + k)
                               for k, blocks in enumerate(REC_EDGE_BLOCKS)]
    for size, case_seed in cases:
        _, nib, nblk = random_nibbles(size, device, case_seed)
        for b in (None, base):
            got = build_rec(nib, nblk, b)
            want = build_rec_plain(nib, nblk, b)
            torch.cuda.synchronize(device)
            err = max(err, int((got.to(torch.int64) - want.to(torch.int64)
                                ).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"rec_build differs from its plain version at {nblk} "
                    f"blocks, base {None if b is None else b.tolist()} "
                    f"(max abs err {err})")
    del got, want
    _, nib, nblk = random_nibbles(n_pos, device, seed)
    lanes = block_counts(nib, nblk).t().contiguous()     # [LANES, NBLK]
    rec = {"name": "rec_build", "route": "cuda",
           "source": "bwtmerge_tpu_torch/csrc/rec_build.cu",
           "replaces": "bwtmerge_tpu/ops/rank_jax.py:416",
           "max_abs_err": err, "positions": n_pos, "nblk": nblk,
           "ms": time_ms(lambda: build_rec(nib, nblk), device),
           "ms_l2_filled": time_ms_cold(lambda: build_rec(nib, nblk), device),
           "plain_ms": time_ms(lambda: build_rec_plain(nib, nblk), device, 3),
           **rec_bound(nblk)}
    rec["library_ms"] = time_ms(
        lambda: torch.cumsum(lanes, dim=1, dtype=torch.int32), device)
    log(f"rec_build: {n_pos} random positions ({nblk} blocks): equal with a "
        f"zero and a random base, and at {list(REC_EDGE_BLOCKS)} blocks; "
        f"{rec['ms']:.4f} ms ({rec['ms_l2_filled']:.4f} ms after the L2 is "
        f"filled) vs plain {rec['plain_ms']:.4f} ms, torch.cumsum of the "
        f"[{LANES}, {nblk}] counts {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.0%})")
    return [rec]


def rec_build_near_limit(device, n_pos: int = REC_LIMIT_POSITIONS,
                         seed: int = 19) -> dict:
    """rec_build at the int32 layout's limit, checked without the plain
    version's scan: row 0's occ is the base; the difference of each two
    neighbouring rows' occ is the upper block's count, and the packed words
    are the plain packing, both computed slab by slab with torch ops; the
    last row plus the last block's counts is the base plus the symbols'
    bincount.  Time and peak memory of the build."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_torch import (LANES, block_counts,
                                                   build_rec,
                                                   pack_symbol_words)

    syms, nib, nblk = random_nibbles(n_pos, device, seed)
    total = sum(torch.bincount(syms[i:i + (1 << 28)], minlength=LANES)
                for i in range(0, n_pos, 1 << 28)).to(torch.int64)
    del syms
    total[6] += nblk * 32 - n_pos                          # the tail's pad
    base = torch.arange(1, LANES + 1, device=device, dtype=torch.int32) * 1000
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    rec = build_rec(nib, nblk, base)
    torch.cuda.synchronize(device)
    first_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(device) - before
    if not torch.equal(rec[0, :LANES], base):
        raise AssertionError("rec_build at the limit: row 0's occ is not "
                             "the base")
    for s0 in range(0, nblk, REC_CHECK_SLAB):
        s1 = min(s0 + REC_CHECK_SLAB, nblk)
        part = nib[s0 * 16: s1 * 16]
        counts = block_counts(part, s1 - s0)
        occ = rec[s0:s1 + 1, :LANES]
        if not torch.equal(occ[1:] - occ[:-1], counts[: occ.shape[0] - 1]):
            raise AssertionError(f"rec_build at the limit: occ steps of "
                                 f"blocks {s0}..{s1} differ from the counts")
        if not torch.equal(rec[s0:s1, LANES:],
                           pack_symbol_words(part, s1 - s0)):
            raise AssertionError(f"rec_build at the limit: packed words of "
                                 f"blocks {s0}..{s1} differ")
        if s1 == nblk:
            last = rec[-1, :LANES].to(torch.int64) + counts[-1]
            if not torch.equal(last - base.to(torch.int64), total):
                raise AssertionError("rec_build at the limit: the last row "
                                     "plus its block's counts is not the "
                                     "bincount of the text")
    result = {"positions": n_pos, "nblk": nblk, "first_call_s": first_s,
              "ms": time_ms(lambda: build_rec(nib, nblk, base), device, 5),
              "peak_bytes_above_inputs": peak,
              "table_bytes": rec.numel() * 4, "nibble_bytes": nib.numel(),
              **rec_bound(nblk)}
    log(f"rec_build near the int32 limit: {json.dumps(result)}")
    del nib
    torch.cuda.empty_cache()
    result["decode_rows_build"] = decode_rows_sampled(device, rec, seed)
    del rec
    torch.cuda.empty_cache()
    return result


XL_PATTERN_SEED = 7      # the xlarge phase's 2^18 patterns
XL_BASE_FOLDS = 3        # the full tier's six, cut for the smoke's time
XL_PROBE_QUERIES = 1 << 17    # batch_count's streamed batch: sp and ep of
XL_PROBE_SENTINELS = 4096     # 2^16 patterns, the ended ones sentinels


def xlarge_kernels(device, base: str, piece: str, out: str) -> dict:
    """Each kernel of the xlarge fold against its plain version on the same
    card tensors, exact, at the shapes the fold gives it: rec_build over
    the nibbles of the base (408 Mbp), of piece 209 (102 Mbp) and of the
    output (612 Mbp); walk_planes_build over the base's and the piece's
    tables; decode_rows_build over the piece's table and K3 over its
    2,000,000 lanes at the fold's first cap; K2 walking those reads through
    the base's planes (step 1's walk) and through the piece's own (the
    shape of step 2's second walk); K1's forms (select also fused) with a
    streamed batch of XL_PROBE_QUERIES sorted queries on the output's
    table, each under its form's name.  These launches are not counted.
    Per kernel: its cases (shape, max abs err, kernel ms over 3 calls,
    plain ms of one call) and its max abs err."""
    import torch

    from bwtmerge_tpu_torch.formats.streaming_read import (alphabet_for,
                                                           read_bwt_chunks)
    from bwtmerge_tpu_torch.ops.decode_torch import (_pow2_at_least,
                                                     build_decode_rows,
                                                     build_decode_rows_plain,
                                                     decode_creads_device,
                                                     decode_creads_plain,
                                                     rows_used)
    from bwtmerge_tpu_torch.ops.rank_torch import (BLK, LANES, DeviceFMIndex,
                                                   build_rec, build_rec_plain,
                                                   c_array,
                                                   pack_nibbles_chunked)
    from bwtmerge_tpu_torch.ops.walk_torch import (build_walk_planes,
                                                   build_walk_planes_plain,
                                                   walk_emit, walk_emit_plain)

    checks = {}

    def timed_once(fn):
        """fn()'s result and the milliseconds of that one call."""
        if device.type != "cuda":
            t0 = time.perf_counter()
            return fn(), (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)

    def held(name, shape, kernel, plain):
        """kernel() against plain(), each a tensor or a tuple of tensors;
        the kernel timed over 3 calls, the plain version (up to seconds a
        call here) by the one call that is compared."""
        got = kernel()
        want, plain_ms = timed_once(plain)
        got, want = [x if isinstance(x, tuple) else (x,) for x in (got, want)]
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"xlarge: {name} differs from its plain "
                                 f"version at {shape} (max abs err {err})")
        del got, want
        case = {"shape": shape, "max_abs_err": err,
                "ms": time_ms(kernel, device, 3), "plain_ms": plain_ms}
        rec = checks.setdefault(name, {"cases": [], "max_abs_err": 0})
        rec["cases"].append(case)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"xlarge: {name} equal to its plain version at {shape}: "
            f"{json.dumps(case)}")

    def index(path, fmt, what):
        nib, counts, size, _ = pack_nibbles_chunked(read_bwt_chunks(path,
                                                                    fmt))
        nblk = size // BLK + 1
        t = torch.from_numpy(nib[: nblk * BLK // 2]).to(device)
        del nib
        held("rec_build", f"{what}, {size} positions",
             lambda: build_rec(t, nblk), lambda: build_rec_plain(t, nblk))
        c = c_array(alphabet_for(fmt, counts, path).counts())
        return DeviceFMIndex(rec=build_rec(t, nblk),
                             C=torch.from_numpy(c).to(device), size=size,
                             n_runs=0)

    def planes_of(idx, what):
        held("walk_planes_build", f"{what}, {idx.rec.shape[0]} blocks",
             lambda: build_walk_planes(idx.rec),
             lambda: build_walk_planes_plain(idx.rec))
        return build_walk_planes(idx.rec)

    def walk(planes, C, creads, what):
        a0 = int(C[1])
        held("walk_emit", f"reads of piece 209 {list(creads.shape)} through "
             f"the {what}'s planes",
             lambda: walk_emit(planes, C, creads, a0),
             lambda: walk_emit_plain(planes, C, creads, a0))

    # piece 209: its table, decode rows and decode (the fold's first cap)
    p_idx = index(piece, "sga", "piece 209")
    held("decode_rows_build", f"piece 209, {p_idx.rec.shape[0]} blocks",
         lambda: build_decode_rows(p_idx.rec),
         lambda: build_decode_rows_plain(p_idx.rec))
    rows = build_decode_rows(p_idx.rec)
    m = int(p_idx.C[1])
    avg = p_idx.size // m
    cap = _pow2_at_least(avg + avg // 4 + 16, 64)
    got = torch.zeros((cap, m), dtype=torch.int8, device=device)
    want = torch.zeros_like(got)
    held("decode", f"piece 209, creads [{cap}, {m}]",
         lambda: (got, decode_creads_device(p_idx, got, 0, rows)),
         lambda: (want, decode_creads_plain(p_idx, want)))
    alive = int(decode_creads_device(p_idx, got, 0, rows))
    if alive:
        raise AssertionError(f"xlarge: {alive} reads of piece 209 outlive "
                             f"the cap of {cap}")
    creads = got[: rows_used(got)].contiguous()
    del rows, want
    p_planes = planes_of(p_idx, "piece 209")
    p_c = p_idx.C
    del p_idx
    walk(p_planes, p_c, creads, "piece")
    del p_planes

    # the base: its table and planes, step 1's walk
    b_idx = index(base, "native", "the base")
    b_planes = planes_of(b_idx, "the base")
    b_c = b_idx.C
    del b_idx
    walk(b_planes, b_c, creads, "base")
    del b_planes, creads, got
    torch.cuda.empty_cache()

    # the output: its table and a streamed batch of the count
    o_idx = index(out, "native", "the output")
    gen = torch.Generator(device=device).manual_seed(XL_PATTERN_SEED)
    q = torch.sort(torch.randint(
        0, o_idx.size + 1, (XL_PROBE_QUERIES - XL_PROBE_SENTINELS,),
        generator=gen, device=device)).values
    q[-1] = o_idx.size
    q = torch.cat([q, torch.full((XL_PROBE_SENTINELS,), 2**31 - 1,
                                 device=device, dtype=q.dtype)]
                  ).to(torch.int32)
    chars = torch.randint(0, LANES, (q.numel(),), generator=gen,
                          device=device, dtype=torch.int32)
    perm = torch.randperm(q.numel(), generator=gen, device=device)
    for form, (kernel, plain, _) in probe_forms(o_idx.rec, q, o_idx.size,
                                                chars, perm).items():
        held(f"streamed_probe.{form.split('_')[0]}",
             f"the output, {o_idx.size} positions, {XL_PROBE_QUERIES} "
             f"sorted queries ({form})", kernel, plain)
    del o_idx, q, chars, perm
    torch.cuda.empty_cache()
    return checks


def xlarge(device) -> tuple:
    """The xlarge tier's 3-way fold (bwtmerge_tpu_torch/xlarge/), its base
    cut to XL_BASE_FOLDS folds: the fixtures built on the card (pieces of
    2,000,000 reads, seeds 201-204, 208 and 209; a 408 Mbp base; cached in
    .smoke_cache/xl/), then bench.run's fold of the base and pieces 209
    and 208 into 612 Mbp, which checks the output's size, and the counts of
    the 4,096 read-derived 32-mers and of 2^18 patterns through batch_count
    (K1) against the inputs'.  Then each kernel of the fold against its
    plain version at the fold's shapes (xlarge_kernels), and the output's
    bytes against the pairwise route's (merge_files of the base and piece
    209, then of that and piece 208: the fold's input order; the other
    order writes other bytes).  Launches of each part are counted apart.
    Returns (the parts' records, the kernels' checks)."""
    from bwtmerge_tpu_torch.models.merge import MergeConfig, merge_files
    from bwtmerge_tpu_torch.xlarge import bench
    from bwtmerge_tpu_torch.xlarge import fixtures as xl

    cache = xl.default_cache()
    seeds = xl.BASE_SEEDS[:XL_BASE_FOLDS]
    result = {}
    steps, counts, wall = drive(lambda: xl.build(cache, device=str(device),
                                                 base_seeds=seeds))
    result["fixtures"] = {"launches": counts, "wall_s": wall, "steps": steps}
    log(f"xlarge fixtures: {json.dumps(result['fixtures'])}")

    pat_path = os.path.join(cache, f"patterns_{N_PATTERNS}.txt")
    if not os.path.exists(pat_path):
        write_patterns(pat_path, [xl.piece_reads(s)[0].reshape(-1, READ_LEN)
                                  for s in (209, 208)], N_PATTERNS,
                       XL_PATTERN_SEED)
    with open(pat_path) as f:
        patterns = f.read().split()
    out = os.path.join(cache, "smoke_fold.native")
    record, counts, wall = drive(lambda: bench.run(
        cache, base_folds=XL_BASE_FOLDS, device=str(device), out_path=out,
        more_patterns=[patterns]))
    # the fold: 3 walks, 2 walk tables, 2 decodes; 7 record tables: the
    # fold's 3 and the counts' 4 (3 inputs and the output), each counting
    # the 2^18 patterns through K1
    want = {"walk_emit": 3, "walk_planes_build": 2, "decode": 2,
            "decode_rows_build": 2, "rec_build": 7, "streamed_probe": 4}
    if device.type == "cuda" and any(counts[k] < n for k, n in want.items()):
        raise AssertionError(f"xlarge fold launched {counts}, needs at "
                             f"least {want}")
    result["fold"] = {"launches": counts, "wall_s": wall, "record": record}
    log(f"xlarge fold: {json.dumps(result['fold'])}")

    paths = [xl.base_path(cache, XL_BASE_FOLDS), xl.piece_path(cache, 209),
             xl.piece_path(cache, 208)]
    t0 = time.monotonic()
    checks = xlarge_kernels(device, paths[0], paths[1], out)
    log(f"xlarge: every kernel of the fold equal to its plain version at "
        f"the fold's shapes, {time.monotonic() - t0:.1f} s")
    mid = os.path.join(cache, "smoke_pair_1.native")
    pair = os.path.join(cache, "smoke_pair_2.native")

    def pairwise():
        phases = []
        for a, b, dst in ((paths[0], paths[1], mid), (mid, paths[2], pair)):
            cfg = MergeConfig(device=str(device), temp_dir=cache,
                              search="auto")
            merge_files(a, b, dst, "native", "native", cfg, in_fmt_b="sga")
            phases.append(cfg.timer.phases)
        return phases

    phases, counts, wall = drive(pairwise)
    same_bytes(pair, out, "xlarge: the pairwise route against the k-way fold")
    result["pairwise"] = {"launches": counts, "wall_s": wall,
                          "phases_s": phases}
    log(f"xlarge pairwise route: {json.dumps(result['pairwise'])}")
    for p in (mid, pair, out):
        os.remove(p)
    return result, checks


BUILDER_SOURCES = ("rec_build.cu", "walk.cu", "decode.cu")
LARGE_A_POSITIONS = LARGE_A_READS * (READ_LEN + 1)
LARGE_B_POSITIONS = 1_000_000 * (READ_LEN + 1)   # bench.py's large B
DECODE_MEDIUM_BLOCKS = 421_957       # K3's piece: 10^6 reads, 13.5 M positions


def builder_build_facts() -> dict:
    """The builders' sources compiled to cubins with -Xptxas -v (one
    nvcc each, together): each kernel's registers, spill bytes and shared
    memory as ptxas states them, its ptxas lines, and from cuobjdump -sass
    its static count of SASS instructions (NOPs left out), of them POPC and
    SHFL.  Loops count once; the builders' per-block work is unrolled."""
    from bwtmerge_tpu_torch import kernels

    nvcc = kernels._nvcc()
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    procs = []
    for src in BUILDER_SOURCES:
        cubin = os.path.join(kernels.BUILD_DIR, src.replace(".cu", ".cubin"))
        procs.append((cubin, subprocess.Popen(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", cubin,
             os.path.join(kernels.CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    facts = {}
    for cubin, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v failed:\n{out}")
        name = None
        for line in out.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                name = kernel_name(m.group(1))
                facts[name] = {"ptxas": []}
            if name is None or "ptxas info" not in line and \
                    "spill" not in line:
                continue
            facts[name]["ptxas"].append(line.strip())
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                facts[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                facts[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                facts[name]["static_smem_bytes"] = int(m.group(1))
        if not os.path.exists(cuobjdump):
            continue
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = kernel_name(m.group(1))
                facts.setdefault(name, {}).update(
                    sass_instructions=0, sass_popc=0, sass_shfl=0)
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if name is None or not m:
                continue
            ops = [t for t in m.group(1).split() if not t.startswith("@")]
            if not ops or ops[0].startswith("NOP"):
                continue
            f = facts[name]
            f["sass_instructions"] += 1
            f["sass_popc"] += ops[0].startswith("POPC")
            f["sass_shfl"] += ops[0].startswith("SHFL")
    for name, f in sorted(facts.items()):
        log(f"ptxas/sass {name}: " + json.dumps(
            {k: v for k, v in f.items() if k != "ptxas"}))
        for line in f.get("ptxas", ()):
            log(f"  {line}")
    return facts


# A probe, not a kernel of the port: each thread reads 16-byte chunks
# kFirst..3 of one 64-byte record and folds them to a word that is stored
# only if it hits a value the probe's table does not hold, so the loads
# stay live and nothing is written.
READ_PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kFirst>
__global__ void read_records(const uint4* __restrict__ rec, int64_t n,
                             unsigned* out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  unsigned acc = 0;
#pragma unroll
  for (int c = kFirst; c < 4; ++c) {
    const uint4 v = __ldg(rec + r * 4 + c);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0xFFFFFFFFu) out[0] = acc;
}

extern "C" int read_records_launch(const void* rec, int64_t n, int half,
                                   void* out, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (half)
    read_records<2><<<blocks, 256, 0, s>>>((const uint4*)rec, n,
                                           (unsigned*)out);
  else
    read_records<0><<<blocks, 256, 0, s>>>((const uint4*)rec, n,
                                           (unsigned*)out);
  return (int)cudaGetLastError();
}
"""


def record_read_probe(device, calls: int, n_rec: int = 1 << 24) -> dict:
    """What device memory moves when a kernel reads one 32-byte half of
    each 64-byte record, as walk_planes_build reads the symbol halves:
    READ_PROBE_CU, built here, reads the second half of every record of a
    1 GiB table (four times the L2) against the whole records.  The ratio
    of the times is 0.5 if 32-byte sectors move alone, 1.0 if whole
    records do."""
    import ctypes

    import torch

    from bwtmerge_tpu_torch import kernels

    src = os.path.join(kernels.BUILD_DIR, "read_probe.cu")
    lib = os.path.join(kernels.BUILD_DIR, "libread_probe.so")
    with open(src, "w") as f:
        f.write(READ_PROBE_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).read_records_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # values below 2^30 never fold to the all-ones word the probe stores
    rec = torch.randint(0, 1 << 30, (n_rec, 16), dtype=torch.int32,
                        device=device)
    out = torch.zeros(1, dtype=torch.int32, device=device)

    def read(half):
        code = fn(rec.data_ptr(), n_rec, half, out.data_ptr(),
                  torch.cuda.current_stream(device).cuda_stream)
        if code:
            raise AssertionError(f"read probe launch failed ({code})")

    res = {"records": n_rec,
           "symbol_half_read_ms": time_ms(lambda: read(1), device, calls),
           "whole_record_read_ms": time_ms(lambda: read(0), device, calls)}
    res["half_over_whole"] = (res["symbol_half_read_ms"]
                              / res["whole_record_read_ms"])
    res["whole_record_read_bytes_s"] = (n_rec * 64
                                        / (res["whole_record_read_ms"] * 1e-3))
    if out.item():
        raise AssertionError("read probe stored a word")
    return res


def builder_profile(device, calls: int = 20) -> dict:
    """The three table builders under torch.profiler: rec_build at the
    medium A's size, the large A's and 2^31 - 2 positions (random symbols),
    walk_planes_build over 100 M positions, and decode_rows_build at K3's
    piece (421,957 blocks), the large B's size and 2^31 - 2 positions; each
    kernel's device microseconds a call and its share of the call's device
    time.  Also
    CUDA-event milliseconds a call of each, taken before the profiler
    starts, and the sources' ptxas and SASS figures, with each builder's
    instructions a record block (the static SASS count of its kernel over
    the blocks a thread builds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwtmerge_tpu_torch.ops import decode_torch, rank_torch
    from bwtmerge_tpu_torch.ops.walk_torch import build_walk_planes

    facts = builder_build_facts()
    result = {"facts": facts, "cases": {}}

    def counted(kernel, per):
        n = facts.get(kernel, {}).get("sass_instructions")
        return n / per if n else None

    result["rec_build_instructions_a_block"] = counted(
        "rec_build_kernel", rank_torch.REC_TILE // rank_torch.REC_THREADS)
    result["walk_planes_build_instructions_a_block"] = counted(
        "walk_planes_build_kernel", 1)
    result["decode_rows_build_instructions_a_block"] = counted(
        "decode_rows_build_kernel", 1)
    cases = [("rec_build_medium", MEDIUM[0] * (READ_LEN + 1)),
             ("rec_build_large_a", LARGE_A_POSITIONS),
             ("rec_build_limit", REC_LIMIT_POSITIONS),
             ("walk_planes_build_100m", K1_POSITIONS),
             ("decode_rows_build_medium", DECODE_MEDIUM_BLOCKS * 32 - 1),
             ("decode_rows_build_large_b", LARGE_B_POSITIONS),
             ("decode_rows_build_limit", REC_LIMIT_POSITIONS)]
    for key, n_pos in cases:
        if key.startswith("rec_build"):
            _, nib, nblk = random_nibbles(n_pos, device, 29)
            fn = (lambda nib=nib, nblk=nblk: rank_torch.build_rec(nib, nblk))
            bnd = rec_bound(nblk)
        elif key.startswith("decode_rows_build"):
            _, nib, nblk = random_nibbles(n_pos, device, 29)
            rec = rank_torch.build_rec(nib, nblk)
            del nib
            fn = (lambda rec=rec: decode_torch.build_decode_rows(rec))
            bnd = decode_rows_bound(nblk)
            del rec
        else:
            idx = random_index(n_pos, device, 29)
            nblk = idx.rec.shape[0]
            fn = (lambda rec=idx.rec: build_walk_planes(rec))
            planes = fn()
            bnd = bound((nblk + planes.shape[0]) * 32 + planes.numel() * 4,
                        nblk * 32 * 5 * 2)
            del planes
        ms = time_ms(fn, device, calls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(device)
        # a profiler started after another in the process may drop some
        # calls' events: each kernel is averaged over its own events
        by = device_us_by_kernel(prof)
        per_call = sum(us / max(c, 1) for c, us in by.values())
        result["cases"][key] = {
            "positions": n_pos, "nblk": nblk, "ms": ms,
            "bound_ms": bnd["bound_ms"], "share_of_bound": bnd["bound_ms"] / ms,
            "profiled_device_us_a_call": per_call,
            "kernels": {k: {"calls": c, "us_a_call": us / max(c, 1),
                            "share": (us / max(c, 1) / per_call
                                      if per_call else None)}
                        for k, (c, us) in sorted(by.items())}}
        log(f"builder profile {key}: {json.dumps(result['cases'][key])}")
        del fn
        torch.cuda.empty_cache()
    result["record_reads"] = record_read_probe(device, calls)
    log(f"record read probe: {json.dumps(result['record_reads'])}")
    return result


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
    if not filecmp.cmp(got, want, shallow=False):
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


def launch_counts() -> dict:
    """Each kernel's launches, and each of K1's forms' under
    "streamed_probe.<form>"."""
    from bwtmerge_tpu_torch import kernels

    return {**kernels.launches(), **kernels.launches_by_form()}


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
    return out, launch_counts(), time.monotonic() - t0


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
        # depth (the full form), two a singles depth (lf and select)
        extra = counts["streamed_probe"] - walk_launches["streamed_probe"]
        if extra < 2 * (READ_LEN + 1) or counts["walk_emit"] \
                or counts["walk_planes_build"] or counts["rec_build"] < 1 \
                or min(counts["streamed_probe.full"],
                       counts["streamed_probe.lf"]) < 1:
            raise AssertionError(
                f"trie main path: {extra} probe launches beyond the walk "
                f"run's, needs {2 * (READ_LEN + 1)}; launches {counts}")
    elif min(counts["streamed_probe.select"], counts["walk_emit"],
             counts["walk_planes_build"], counts["rec_build"]) < 1 \
            or counts["decode"]:
        raise AssertionError(f"the two-input main path launched {counts}: "
                             f"needs K1 (its select form, the -v counts), "
                             f"K2, walk_planes_build and rec_build, and no "
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
            "decode": 3, "decode_rows_build": 3, "rec_build": len(paths)}
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


def bench_cell(device, cell: str = "large-trie") -> dict:
    """One cell of the port's benchmark through its own entry point
    (bwtmerge_tpu_torch.bench.main, one timed pass and no longer window;
    fixtures and the reference BWT cached in .smoke_cache/bench/): it must
    exit 0 and its line say correct: true."""
    from bwtmerge_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, counts, wall = drive(lambda: bench.main(
            ["--cell", cell, "--passes", "1", "--window-s", "0", "--device",
             str(device), "--cache", os.path.join(CACHE, "bench")]))
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    result = {"launches": counts, "wall_s": wall, "rc": rc,
              **{k: line.get(k) for k in ("correct", "gate", "card",
                                          "merge_mbases_s", "setup_s")}}
    log(f"bench --cell {cell} --passes 1: {json.dumps(result)}")
    if rc != 0 or line.get("correct") is not True:
        raise AssertionError(f"bench --cell {cell}: exit {rc}, gate "
                             f"{line.get('gate')}")
    return result


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


LARGE = (2_000_000, 1_000_000)    # bench.py SCALES["large"] reads, A and B
LARGE_SEEDS = (101, 102)          # bench.py:134
LARGE_BLOCKS = 8                  # bench.py SCALES["large"] search blocks
LARGE_BUDGET = ("3", "2")         # -r 3 -m 2: 6 Mi runs, bench.py's threshold
CELL_PATTERNS = CELLS["large-walk-v"].patterns   # its -v file: 2^21 32-mers
# the count's chunk sizes timed side by side: 2^16 rows (the JAX package's
# chunk, and the port's before the count budget), 2^18, 2^21 (one chunk)
COUNT_SPLIT_ROWS = (1 << 16, 1 << 18, 1 << 21)


def build_large_fixture(device, path: str, m: int, seed: int,
                        sidecar: bool) -> dict:
    """SGA file of the BWT of m random 50 bp reads (bench.py's recipe and
    seed) built on the card by the port's build_from_reads, with the
    read-text sidecar when asked; the symbol counts checked against the
    reads'.  Cached by path."""
    from bwtmerge_tpu_torch.formats import write_bwt
    from bwtmerge_tpu_torch.formats.sidecar import sidecar_path, write_sidecar
    from bwtmerge_tpu_torch.models.build import alphabet_for, build_from_reads

    if os.path.exists(path) and (not sidecar
                                 or os.path.exists(sidecar_path(path))):
        return {"cached": True}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat, lengths = packed_reads(m, seed)
    t0 = time.monotonic()
    runs, _ = build_from_reads((flat, lengths), backend="torch",
                               device=str(device))
    t1 = time.monotonic()
    want = np.bincount(flat, minlength=6)
    want[0] = m
    if not np.array_equal(runs.counts(6), want):
        raise AssertionError(f"device build of {m} reads: symbol counts "
                             f"{runs.counts(6)} for {want}")
    write_bwt(path, "sga", runs, alphabet_for(runs))
    if sidecar:
        write_sidecar(sidecar_path(path), lengths, flat)
    return {"cached": False, "build_s": t1 - t0,
            "write_s": time.monotonic() - t1, "runs": runs.n_runs}


def rec_build_memory(device, path: str) -> dict:
    """The large A's record table built by rec_build and by the plain
    version from the same nibbles: milliseconds and the peak of device
    memory above the nibbles, each; the two tables equal.  Then the whole
    index build (DeviceFMIndex.build: host pack, upload, table) of the
    large A in turns with rec_build and with the plain version in its
    place, which is the build before rec_build: seconds each."""
    import torch

    from bwtmerge_tpu_torch.formats import read_bwt
    from bwtmerge_tpu_torch.native import nib4_pack
    from bwtmerge_tpu_torch.ops import rank_torch
    from bwtmerge_tpu_torch.ops.rank_torch import (BLK, NIB_FILL, build_rec,
                                                   build_rec_plain)

    runs, _, _ = read_bwt(path, "sga")
    nblk = runs.size() // BLK + 1
    host = np.full(nblk * BLK // 2, NIB_FILL, dtype=np.uint8)
    nib4_pack(runs.syms, runs.lens, host)
    nib = torch.from_numpy(host).to(device)
    out = {"positions": int(runs.size()), "nblk": nblk}
    tables = {}
    for key, fn in (("kernel", build_rec), ("plain", build_rec_plain)):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        tables[key] = fn(nib, nblk)
        torch.cuda.synchronize(device)
        out[f"{key}_peak_bytes_above_nibbles"] = (
            torch.cuda.max_memory_allocated(device) - before)
        out[f"{key}_ms"] = time_ms(lambda: fn(nib, nblk), device,
                                   20 if key == "kernel" else 2)
    if not torch.equal(tables["kernel"], tables["plain"]):
        raise AssertionError("rec_build differs from its plain version on "
                             "the large A")
    out["table_bytes"] = tables["kernel"].numel() * 4
    out.update(rec_bound(nblk))
    del tables, nib
    counts = runs.counts(6)
    for key in ("kernel", "plain", "plain", "kernel"):
        torch.cuda.empty_cache()
        if key == "plain":
            rank_torch.build_rec = build_rec_plain
        try:
            t0 = time.monotonic()
            idx = rank_torch.DeviceFMIndex.build(runs, counts, device)
            torch.cuda.synchronize(device)
            took = time.monotonic() - t0
        finally:
            rank_torch.build_rec = build_rec
        out.setdefault(f"index_build_s_{key}", []).append(took)
        del idx
    torch.cuda.empty_cache()
    return out


def counts_by_chunk(device, fmi, patterns, counted, chunk_rows) -> list:
    """The patterns (a PatternBatch) counted again in fmi's device index,
    built first, once at each number of rows a chunk, each in a window of
    its own with the kernels' launch counts set to 0 just before: search
    seconds on the host clock (batch_count ends in the counts' copy), K1
    launches (ceil(Q / rows) chunks of max_len - 1 steps), and the peak of
    device memory above what was allocated before the count (the index and
    the run's pattern bytes).  Every size must give `counted`, the merge's
    own count."""
    import torch

    from bwtmerge_tpu_torch import kernels
    from bwtmerge_tpu_torch.ops.rank_torch import (COUNT_CHAR_BYTES,
                                                   COUNT_ROW_BYTES,
                                                   batch_count,
                                                   count_chunk_rows)

    idx = fmi.device_index(device)
    q = len(patterns)
    max_len = max(map(len, patterns.patterns))
    out = []
    for rows in chunk_rows:
        budget = rows * (COUNT_ROW_BYTES + COUNT_CHAR_BYTES * max_len)
        if count_chunk_rows(max_len, budget) != rows:
            raise AssertionError(f"a budget of {budget} B gives "
                                 f"{count_chunk_rows(max_len, budget)}"
                                 f" rows a chunk, not {rows}")
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        t0 = time.monotonic()
        got = batch_count(idx, patterns, fmi.alpha.char2comp, budget)
        took = time.monotonic() - t0
        k1 = kernels.launches()["streamed_probe"]
        want_k1 = (-(-q // rows) * (max_len - 1)
                   if device.type == "cuda" else 0)
        if k1 != want_k1 or not np.array_equal(got, counted):
            raise AssertionError(
                f"the count at {rows} rows a chunk launched K1 {k1} "
                f"times (not {want_k1}) or differs from the merge's "
                f"({int(got.sum())} against {int(counted.sum())} "
                f"occurrences)")
        out.append({"chunk_rows": rows, "search_s": took,
                    "k1_launches": k1,
                    "peak_bytes_above": int(
                        torch.cuda.max_memory_allocated(device) - before),
                    "occurrences": int(got.sum())})
    return out


def recount_by_chunk(device, split, counted, inputs, output,
                     chunk_rows) -> None:
    """After a merge run under count_split: each of its counts made again
    at each of chunk_rows rows a chunk (counts_by_chunk), in the index of
    the file it counted (the inputs in order, then the output), loaded
    anew, with the run's own counts as the reference.  Adds by_chunk_rows
    to each record of split."""
    import torch

    import bwtmerge_tpu_torch as port

    paths = {"Input": list(inputs), "Output": [output]}
    for rec, (role, patterns, counts) in zip(split, counted):
        fmi = port.load_fmi(paths[role].pop(0), "sga")
        rec["by_chunk_rows"] = counts_by_chunk(device, fmi, patterns, counts,
                                               chunk_rows)
        del fmi
        torch.cuda.empty_cache()


@contextlib.contextmanager
def count_split(device):
    """Within the block, each -v count of the merge CLI is split into its
    parts, on the host clock, each part ending in a synchronize: the
    patterns' encoding (rank_torch.encode_patterns per count, or the byte
    matrix of rank_torch.pattern_bytes, built once a run, where the tree
    has it), the build of its index on the device, and the rest (mapping,
    search, the counts' copy).  Yields (split, counted): the list of
    {role, count_s, encode_s, index_build_s, search_s}, and for each count
    (role, patterns, its counts), for recount_by_chunk once the run is
    over."""
    import torch

    from bwtmerge_tpu_torch.cli import bwt_merge
    from bwtmerge_tpu_torch.ops import rank_torch

    split, counted = [], []
    encode = {"s": 0.0, "open": False}
    plain = {"verify_fmi": bwt_merge.verify_fmi}
    names = [n for n in ("encode_patterns", "pattern_bytes")
             if hasattr(rank_torch, n)]

    def timed_encode(fn):
        def run(*args, **kw):
            if encode["open"]:           # one encoder calling the other
                return fn(*args, **kw)
            encode["open"] = True
            t0 = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                encode["open"] = False
                encode["s"] += time.monotonic() - t0
        return run

    def verify(fmi, role, patterns, results, *args, **kw):
        e0 = encode["s"]
        r0 = results.copy()
        with indexes_built(device) as built:
            t0 = time.monotonic()
            plain["verify_fmi"](fmi, role, patterns, results, *args, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            total = time.monotonic() - t0
        enc = encode["s"] - e0
        build = sum(s for *_, s in built)
        split.append({"role": role, "count_s": total, "encode_s": enc,
                      "index_build_s": build,
                      "search_s": total - enc - build})
        counted.append((role, patterns, results - r0))

    for n in names:
        plain[n] = getattr(rank_torch, n)
        setattr(rank_torch, n, timed_encode(plain[n]))
    bwt_merge.verify_fmi = verify
    try:
        yield split, counted
    finally:
        bwt_merge.verify_fmi = plain["verify_fmi"]
        for n in names:
            setattr(rank_torch, n, plain[n])


@contextlib.contextmanager
def search_split(device):
    """Within the block, each search phase of a two-input merge
    (models/merge._build_ra) is split into its parts, on the host clock,
    each part ending in a synchronize: the sidecar's read, hash and unpack
    (formats/sidecar.read_sidecar), the walk layout (creads_layout), the
    gate's composition count (_creads_consistent less its spot check), the
    spot check's SparseRankIndex build and its LF walk (_creads_spotcheck
    less the build), A's device index, build_walk_planes, blocked_walk
    with its copies to the host, and _prime_stream; rest_s is the phase
    less its parts.  Yields the list of {part_s: seconds, search_s}, one a
    search phase."""
    import torch

    from bwtmerge_tpu_torch.formats import sidecar
    from bwtmerge_tpu_torch.models import fmi, merge
    from bwtmerge_tpu_torch.ops import ra_stream, rank_np, walk_torch

    splits = []
    open_ = []                   # the search phase being split, if any

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                if open_:
                    open_[0][key] = (open_[0].get(key, 0.0)
                                     + time.monotonic() - t0)
        return run

    def timed_search(*args, **kw):
        open_.append({})
        try:
            out = timed("search_s", plain["_build_ra"])(*args, **kw)
        finally:
            part = open_.pop()
        part["composition_s"] = (part.get("consistent_s", 0.0)
                                 - part.get("spotcheck_s", 0.0))
        part["spot_walk_s"] = (part.pop("spotcheck_s", 0.0)
                               - part.get("rank_index_s", 0.0))
        part.pop("consistent_s", None)
        part["rest_s"] = part["search_s"] - sum(
            v for k, v in part.items() if k not in ("search_s", "rest_s"))
        splits.append(part)
        return out

    build = rank_np.SparseRankIndex.build.__func__
    plain = {"_build_ra": merge._build_ra,
             "_creads_consistent": merge._creads_consistent,
             "_creads_spotcheck": merge._creads_spotcheck,
             "_prime_stream": merge._prime_stream,
             "read_sidecar": sidecar.read_sidecar,
             "creads_layout": sidecar.creads_layout,
             "device_index": fmi.FMI.device_index,
             "build_walk_planes": walk_torch.build_walk_planes,
             "blocked_walk": ra_stream.blocked_walk}
    keys = {"_creads_consistent": "consistent_s",
            "_creads_spotcheck": "spotcheck_s",
            "_prime_stream": "prime_stream_s",
            "read_sidecar": "sidecar_read_s", "creads_layout": "layout_s",
            "device_index": "device_index_s",
            "build_walk_planes": "walk_planes_s",
            "blocked_walk": "blocked_walk_s"}
    owners = {"read_sidecar": sidecar, "creads_layout": sidecar,
              "device_index": fmi.FMI, "build_walk_planes": walk_torch,
              "blocked_walk": ra_stream}
    for name, key in keys.items():
        setattr(owners.get(name, merge), name, timed(key, plain[name]))
    merge._build_ra = timed_search
    rank_np.SparseRankIndex.build = classmethod(
        timed("rank_index_s", build))
    try:
        yield splits
    finally:
        for name, fn in plain.items():
            setattr(owners.get(name, merge), name, fn)
        rank_np.SparseRankIndex.build = classmethod(build)


def search_splits(device, passes: int) -> dict:
    """large-walk-v's and large-walk-spill's merges (the bench's arguments,
    no -v) of the large pair, in turns, `passes` times each, every search
    phase split by search_split: {cell: [split, ...]}."""
    d = os.path.join(CACHE, f"large_{LARGE[0]}_{LARGE[1]}")
    a_path, b_path = os.path.join(d, "a.sga"), os.path.join(d, "b.sga")
    for path, m, seed, side in ((a_path, LARGE[0], LARGE_SEEDS[0], False),
                                (b_path, LARGE[1], LARGE_SEEDS[1], True)):
        build_large_fixture(device, path, m, seed, side)
    spill_dir = os.path.join(d, "spill")
    os.makedirs(spill_dir, exist_ok=True)
    out = os.path.join(d, "merged_split.sga")
    cells = {"large-walk-v": [],
             "large-walk-spill": ["--device-blocks", str(LARGE_BLOCKS), "-r",
                                  LARGE_BUDGET[0], "-m", LARGE_BUDGET[1],
                                  "-d", spill_dir]}
    result = {cell: [] for cell in cells}
    for _ in range(passes):
        for cell, extra in cells.items():
            with search_split(device) as split:
                rc, *_ = run_cli([a_path, b_path, out, "-i", "sga", "-o",
                                  "sga", "--device", str(device), *extra])
            if rc != 0 or len(split) != 1:
                raise AssertionError(f"{cell}: exit {rc}, {len(split)} "
                                     f"search phases")
            result[cell].append(split[0])
    os.remove(out)
    return result


@contextlib.contextmanager
def pass_split(device):
    """Within the block, each pass of the merge CLI (bwt_merge.main) is
    split into its parts, on the host clock, each part ending in a
    synchronize: load_fmi of A and of B, the merge's phases as its
    PhaseTimer names them (search, merge, index build), RunArrays.counts
    inside write_bwt, the SGA writer (SGAFormat.write), and rest_s, the
    pass less its parts.  Yields the list of {part_s: seconds, pass_s},
    one a pass."""
    import torch

    from bwtmerge_tpu_torch import formats
    from bwtmerge_tpu_torch.cli import bwt_merge
    from bwtmerge_tpu_torch.models.runs import RunArrays
    from bwtmerge_tpu_torch.utils.metrics import PhaseTimer

    splits = []
    open_ = []                   # the pass being split, if any
    writing = []                 # inside write_bwt
    phase_keys = {"search (rank array)": "search_s",
                  "merge (interleave)": "merge_s",
                  "index build": "index_build_s"}

    def add(key, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if open_:
            key = key() if callable(key) else key
            open_[0][key] = open_[0].get(key, 0.0) + time.monotonic() - t0

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                add(key, t0)
        return run

    def loads():
        return "load_b_s" if "load_a_s" in open_[0] else "load_a_s"

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.monotonic()
        try:
            with plain["phase"](self, name):
                yield
        finally:
            add(phase_keys.get(name, name), t0)

    def counts(self, *args, **kw):
        if not writing:
            return plain["counts"](self, *args, **kw)
        return timed("counts_s", plain["counts"])(self, *args, **kw)

    def write_bwt(*args, **kw):
        writing.append(True)
        try:
            return plain["write_bwt"](*args, **kw)
        finally:
            writing.pop()

    def main(*args, **kw):
        open_.append({})
        try:
            return timed("pass_s", plain["main"])(*args, **kw)
        finally:
            part = open_.pop()
            part["rest_s"] = part["pass_s"] - sum(
                v for k, v in part.items() if k != "pass_s")
            splits.append(part)

    sga = formats.SGAFormat
    plain = {"main": bwt_merge.main, "load_fmi": bwt_merge.load_fmi,
             "phase": PhaseTimer.phase, "counts": RunArrays.counts,
             "write_bwt": formats.write_bwt,
             "sga_write": sga.__dict__["write"]}
    bwt_merge.main = main
    bwt_merge.load_fmi = timed(loads, plain["load_fmi"])
    PhaseTimer.phase = phase
    RunArrays.counts = counts
    formats.write_bwt = write_bwt
    sga.write = classmethod(timed("sga_write_s",
                                  plain["sga_write"].__func__))
    try:
        yield splits
    finally:
        bwt_merge.main, bwt_merge.load_fmi = plain["main"], plain["load_fmi"]
        PhaseTimer.phase, RunArrays.counts = plain["phase"], plain["counts"]
        formats.write_bwt = plain["write_bwt"]
        sga.write = plain["sga_write"]


def pass_splits(device, passes: int) -> dict:
    """large-walk-v's and large-trie's passes without -v (the bench's own
    arguments, bench.CELLS) over the large pair, in turns, `passes` times
    each, every pass split by pass_split: {cell: [split, ...]}."""
    from bwtmerge_tpu_torch.bench import CELLS

    d = os.path.join(CACHE, f"large_{LARGE[0]}_{LARGE[1]}")
    a_path, b_path = os.path.join(d, "a.sga"), os.path.join(d, "b.sga")
    for path, m, seed, side in ((a_path, LARGE[0], LARGE_SEEDS[0], False),
                                (b_path, LARGE[1], LARGE_SEEDS[1], True)):
        build_large_fixture(device, path, m, seed, side)
    spill_dir = os.path.join(d, "spill")
    os.makedirs(spill_dir, exist_ok=True)
    out = os.path.join(d, "merged_pass_split.sga")
    cells = ("large-walk-v", "large-trie")
    result = {cell: [] for cell in cells}
    for _ in range(passes):
        for cell in cells:
            with pass_split(device) as split:
                rc, *_ = run_cli([a_path, b_path, out, "-i", "sga", "-o",
                                  "sga", "--device", str(device), "-d",
                                  spill_dir, *CELLS[cell].args])
            if rc != 0 or len(split) != 1 or "load_b_s" not in split[0]:
                raise AssertionError(f"{cell}: exit {rc}, split {split}")
            result[cell].append(split[0])
            log(f"{cell}, a pass split: {json.dumps(split[0])}")
    os.remove(out)
    return result


def large_path(device) -> dict:
    """The two-input walk merge at bench.py's large scale: A of 2,000,000
    and B of 1,000,000 random 50 bp reads (bench.py's seeds; B with its
    sidecar), built on the card by the port and cached.  bwt_merge A B out
    -v patterns --device-blocks 8 -r 3 -m 2 -d DIR: the rank array past 6
    Mi runs drains into several spill files; the output must equal, byte
    for byte, the same merge's without the spill and the --search trie
    merge's; rec_build must have launched once an index built.  The
    unspilled walk merge takes large-walk-v's own -v file (2^21 32-mers,
    bench.write_patterns): each of its three counts split into encoding,
    index build and search (count_split), on a line before the run's, K1
    launched exactly 3 x 31 times (each count one chunk of 31 steps), and
    once the run is over each count made again at COUNT_SPLIT_ROWS rows a
    chunk (recount_by_chunk).  Then K1
    at the count's shape over the large A (count_probe_times), and the
    large A's table by rec_build and by the plain version: time and peak
    device memory."""
    from bwtmerge_tpu_torch.formats import read_bwt
    from bwtmerge_tpu_torch.ops.rank_torch import count_chunk_rows

    d = os.path.join(CACHE, f"large_{LARGE[0]}_{LARGE[1]}")
    a_path, b_path = os.path.join(d, "a.sga"), os.path.join(d, "b.sga")
    t0 = time.monotonic()
    made = {"a": build_large_fixture(device, a_path, LARGE[0], LARGE_SEEDS[0],
                                     False),
            "b": build_large_fixture(device, b_path, LARGE[1], LARGE_SEEDS[1],
                                     True)}
    pat_path = os.path.join(d, f"patterns_{N_PATTERNS}.txt")
    if not os.path.exists(pat_path):
        write_patterns(pat_path, [reads_of(m, seed) for m, seed
                                  in zip(LARGE, LARGE_SEEDS)], N_PATTERNS, 3)
    cell_pat = os.path.join(d, f"patterns_{CELL_PATTERNS}.txt")
    if not os.path.exists(cell_pat):
        write_patterns(cell_pat, [reads_of(m, seed) for m, seed
                                  in zip(LARGE, LARGE_SEEDS)], CELL_PATTERNS,
                       3)
    log(f"large fixtures ready in {time.monotonic() - t0:.1f} s: "
        f"{json.dumps(made)}")
    spill_dir = os.path.join(d, "spill")
    os.makedirs(spill_dir, exist_ok=True)
    common = ["-i", "sga", "-o", "sga", "--device", str(device)]
    runs_of = {
        "spilled_walk_v": ["-v", pat_path, "--device-blocks",
                           str(LARGE_BLOCKS), "-r", LARGE_BUDGET[0], "-m",
                           LARGE_BUDGET[1], "-d", spill_dir],
        "walk": ["-v", cell_pat, "--device-blocks", str(LARGE_BLOCKS)],
        "trie": ["--search", "trie"]}
    b_bases = read_bwt(b_path, "sga")[0].size()
    result = {"a_reads": LARGE[0], "b_reads": LARGE[1], "b_bases": b_bases}
    outs = {}
    for name, extra in runs_of.items():
        outs[name] = os.path.join(d, f"merged_{name}.sga")
        split_of = count_split(device) if name == "walk" \
            else contextlib.nullcontext((None, None))
        with spill_files_made() as spilled, \
                indexes_built(device) as built, \
                split_of as (split, counted), \
                search_split(device) as searched:
            rc, std, err, counts, wall = run_cli(
                [a_path, b_path, outs[name], *common, *extra])
        if rc != 0:
            raise AssertionError(f"large merge {name} exited {rc}")
        n_tables = sum(slabs for _, _, slabs, _ in built)
        if device.type == "cuda" and counts["rec_build"] != n_tables:
            raise AssertionError(f"large merge {name}: rec_build launched "
                                 f"{counts['rec_build']} times for "
                                 f"{n_tables} record tables built")
        if name == "spilled_walk_v" and (len(spilled) < 2
                                         or os.listdir(spill_dir)):
            raise AssertionError(f"large merge {name}: spill files "
                                 f"{spilled}, left {os.listdir(spill_dir)}")
        if name != "spilled_walk_v" and spilled:
            raise AssertionError(f"large merge {name} spilled {spilled}")
        need = ("streamed_probe", "walk_emit", "walk_planes_build") \
            if name != "trie" else ("streamed_probe",)
        if device.type == "cuda" and any(counts[k] < 1 for k in need):
            raise AssertionError(f"large merge {name} launched {counts}")
        if name == "walk":
            # K1 only in the counts: each count's 2^21 32-mers are one
            # chunk at the default budget, searched in 31 steps
            if count_chunk_rows(PATTERN_LEN) < CELL_PATTERNS:
                raise AssertionError(
                    f"{CELL_PATTERNS} {PATTERN_LEN}-mers do not fit in one "
                    f"chunk ({count_chunk_rows(PATTERN_LEN)} rows)")
            k1 = 3 * (PATTERN_LEN - 1)
            if device.type == "cuda" and counts["streamed_probe"] != k1:
                raise AssertionError(f"large walk -v launched K1 "
                                     f"{counts['streamed_probe']} times, "
                                     f"not {k1}")
            recount_by_chunk(device, split, counted, (a_path, b_path),
                             outs[name], COUNT_SPLIT_ROWS)
            log(f"large walk -v, {CELL_PATTERNS} patterns, each count "
                f"split: {json.dumps(split)}")
        if name != "trie":
            log(f"large merge {name}, its search split: "
                f"{json.dumps(searched)}")
        phases = phase_times(err)
        merge_s = (phases.get("search (rank array)", 0)
                   + phases.get("merge (interleave)", 0))
        result[name] = {
            "phases_s": phases, "verify_s": verify_times(std),
            "index_builds": [{"kind": k, "positions": n, "tables": t,
                              "s": sec} for k, n, t, sec in built],
            "spill_files": len(spilled),
            "spill_bytes": sum(x[1] for x in spilled),
            **({"count_split": split} if split else {}),
            "merge_mbases_s": b_bases / 1e6 / max(merge_s, 1e-9),
            "wall_s": wall, "launches": counts}
        log(f"large merge ({name}), {LARGE[0]}+{LARGE[1]} reads: "
            f"{json.dumps(result[name])}")
    for name in ("walk", "trie"):
        same_bytes(outs[name], outs["spilled_walk_v"],
                   f"large merge, {name} against the spilled walk")
    for out in outs.values():
        os.remove(out)
    result["k1_count_shape"] = count_probe_times(device, a_path, cell_pat)
    result["rec_build_large_a"] = rec_build_memory(device, a_path)
    log(f"rec_build and the plain build, large A: "
        f"{json.dumps(result['rec_build_large_a'])}")
    result["decode_rows_large_b"] = decode_rows_large_b(device, b_path)
    return result


def count_probe_times(device, a_path: str, pat_path: str) -> dict:
    """K1 at a -v count's shape: the select form's keys, characters and
    permutation at every step of the count of pat_path's patterns (2^21
    32-mers: 2^22 keys a step, the finished ends as 2^31-1 sentinels) in
    the large A's index, taken from one count and replayed.  At each
    step's keys: the select form as the count launches it (fused: the
    characters read and the ranks written through the sort's permutation)
    and the full form, each against its plain version, exact; then timed,
    each with its bound (probe_bound): the fused select, the select alone
    on the characters beside the sorted keys, the step's work without the
    fusion (the gather of the characters, that select and the scatter of
    the ranks), and the full form.  Sums over the count's steps, the mean
    a launch, and each share of its bound."""
    import torch

    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.cli.common import read_rows
    from bwtmerge_tpu_torch.ops import rank_streamed as rs
    from bwtmerge_tpu_torch.ops.rank_torch import batch_count

    fmi = port.load_fmi(a_path, "sga")
    idx = fmi.device_index(device)
    rec, size = idx.rec, idx.size
    patterns = read_rows(pat_path)
    steps = []
    select = rs.streamed_select

    def keep(rec, q, chars, size, perm=None):
        steps.append((q.clone(), chars.clone(), perm.clone()))
        return select(rec, q, chars, size, perm)

    rs.streamed_select = keep
    try:
        batch_count(idx, patterns, fmi.alpha.char2comp)
    finally:
        rs.streamed_select = select

    def unfused(q, chars, perm):
        rk_sorted = select(rec, q, chars[perm], size)
        rk = torch.empty_like(rk_sorted)
        rk[perm] = rk_sorted
        return rk

    ways = ("select_fused", "select", "full")
    out = {"positions": size, "patterns": len(patterns),
           "launches": len(steps), "queries": int(steps[0][0].numel()),
           "live_queries": 0, "max_abs_err": 0, "unfused_step_ms": 0.0,
           "unfused_step_wrapper_ms": 0.0,
           **{w: {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_ms_with_zero_rows": 0.0,
                  "bound_by": set()}
              for w in ways}}
    for q, chars, perm in steps:
        forms = probe_forms(rec, q, size, chars, perm)
        for w in ("select_fused", "full"):
            kernel, plain, _ = forms[w]
            out["max_abs_err"] = max(out["max_abs_err"], held_equal(
                f"K1's {w} form at the count's keys", kernel, plain, device))
        out["max_abs_err"] = max(out["max_abs_err"], held_equal(
            "the count's step without the fusion",
            lambda: unfused(q, chars, perm), forms["select_fused"][1],
            device))
        for w in ways:
            kernel, plain, bnd = forms[w]
            fig = out[w]
            fig["ms"] += time_ms_graph(kernel, device)
            fig["wrapper_ms"] += time_ms(kernel, device)
            fig["plain_ms"] += time_ms(plain, device, 2)
            fig["bound_ms"] += bnd["bound_ms"]
            fig["bound_ms_with_zero_rows"] += bnd["bound_ms_with_zero_rows"]
            fig["bound_by"].add(bnd["bound_by"])
        out["unfused_step_ms"] += time_ms_graph(
            lambda: unfused(q, chars, perm), device)
        out["unfused_step_wrapper_ms"] += time_ms(
            lambda: unfused(q, chars, perm), device)
        out["live_queries"] += int((q <= size).sum())
    for w in ways:
        fig = out[w]
        fig["bound_by"] = "/".join(sorted(fig["bound_by"]))
        fig["ms_a_launch"] = fig["ms"] / len(steps)
        fig["wrapper_ms_a_launch"] = fig["wrapper_ms"] / len(steps)
        fig["bound_ms_a_launch"] = fig["bound_ms"] / len(steps)
        fig["share_of_bound"] = fig["bound_ms"] / fig["ms"]
        fig["share_of_bound_with_zero_rows"] = (
            fig["bound_ms_with_zero_rows"] / fig["ms"])
    out["unfused_step_ms_a_launch"] = out["unfused_step_ms"] / len(steps)
    out["unfused_step_wrapper_ms_a_launch"] = (
        out["unfused_step_wrapper_ms"] / len(steps))
    log(f"K1 at the count's shape, large A: equal; {json.dumps(out)}")
    del steps, idx, fmi
    torch.cuda.empty_cache()
    return out


def probe_only(device) -> dict:
    """K1's forms alone (`--probe`): check_probe_forms at the kernels
    phase's shapes, then count_probe_times over the large A (built and
    cached as large_path builds it)."""
    import torch

    measure_copy_rate(device)
    idx = random_index(K1_POSITIONS, device, 7)
    gen = torch.Generator(device=device).manual_seed(8)
    records = check_probe_forms(device, idx, gen, K1_QUERIES, K1_SENTINELS)
    del idx
    torch.cuda.empty_cache()
    d = os.path.join(CACHE, f"large_{LARGE[0]}_{LARGE[1]}")
    a_path = os.path.join(d, "a.sga")
    build_large_fixture(device, a_path, LARGE[0], LARGE_SEEDS[0], False)
    cell_pat = os.path.join(d, f"patterns_{CELL_PATTERNS}.txt")
    if not os.path.exists(cell_pat):
        write_patterns(cell_pat, [reads_of(m, seed) for m, seed
                                  in zip(LARGE, LARGE_SEEDS)], CELL_PATTERNS,
                       3)
    return {"records": records,
            "count_shape": count_probe_times(device, a_path, cell_pat)}


def decode_rows_large_b(device, path: str) -> dict:
    """decode_rows_build over the large B's record table (a real BWT of
    1,000,000 reads) against its plain version, exact; both timed."""
    import torch

    from bwtmerge_tpu_torch.formats import read_bwt
    from bwtmerge_tpu_torch.ops.decode_torch import (build_decode_rows,
                                                     build_decode_rows_plain)
    from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex

    runs, _, _ = read_bwt(path, "sga")
    idx = DeviceFMIndex.build(runs, runs.counts(6), device)
    got = build_decode_rows(idx.rec)
    want = build_decode_rows_plain(idx.rec)
    torch.cuda.synchronize(device)
    if not torch.equal(got, want):
        raise AssertionError("decode_rows_build differs from its plain "
                             "version on the large B")
    nblk = idx.rec.shape[0]
    out = {"positions": idx.size, "nblk": nblk,
           "ms": time_ms(lambda: build_decode_rows(idx.rec), device),
           "plain_ms": time_ms(lambda: build_decode_rows_plain(idx.rec),
                               device, 3),
           **decode_rows_bound(nblk)}
    log(f"decode_rows_build, large B: equal; {json.dumps(out)}")
    del got, want, idx
    torch.cuda.empty_cache()
    return out


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
                    "sharded_index": {"rec_build": 2 * n}}[name]
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
    figures["launches"] = launch_counts()
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


MAIN_PATHS = ("two_input_merge", "kway_fold", "trie_merge")


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
    if len(sys.argv) > 2 and sys.argv[1] == "--search-split":
        # only the large walk merges' search phases, split: no result line
        log(json.dumps({"search_split": search_splits(device,
                                                      int(sys.argv[2]))}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--probe":
        # only K1's forms, at random keys and at a -v count's: no result line
        log(json.dumps({"probe": probe_only(device)}))
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--pass-split":
        # only the large pair's passes, split: no result line
        log(json.dumps({"pass_split": pass_splits(device,
                                                  int(sys.argv[2]))}))
        return 0
    count_pinned_blocks()
    with Fixtures() as fixtures:
        measure_copy_rate(device)
        records = check_kernels(device, K1_POSITIONS, K1_QUERIES,
                                K1_SENTINELS, K2_SHAPE)
        records += check_decode(device, fixtures.get("k3"))
        records += check_rec_build(device)
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
        # bench.py's large scale, then the record build near the layout's
        # limit
        large = large_path(device)
        for key in ("spilled_walk_v", "walk", "trie"):
            paths[f"large_{key}"] = large[key]
        count_shape = large["k1_count_shape"]
        for rec in records:
            if rec["name"] == "streamed_probe.select":
                rec["count_shape"] = count_shape
            elif rec["name"] == "streamed_probe.full":
                rec["count_shape"] = count_shape["full"]
        log(json.dumps({"pass_split": pass_splits(device, 1)}))
        rec_build_near_limit(device)
        # the xlarge tier's 3-way fold, its base cut to three folds
        parts, xl_checks = xlarge(device)
        for key, part in parts.items():
            paths[f"xlarge_{key}"] = part
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
        paths["bench_large_trie"] = bench_cell(device)
        cli_profile(device, fixtures)
        profiled = builder_profile(device)
    for rec in records:
        if rec["name"] in ("rec_build", "walk_planes_build",
                           "decode_rows_build"):
            key = rec["name"]
            prefix = {"rec_build": "rec_", "walk_planes_build": "walk_planes",
                      "decode_rows_build": "decode_rows"}[key]
            rec["instructions_a_block"] = profiled[
                f"{key}_instructions_a_block"]
            rec["sass"] = {k: {f: v for f, v in fact.items() if f != "ptxas"}
                           for k, fact in profiled["facts"].items()
                           if k.startswith(prefix)}
            rec["profile"] = {c: {"ms": r["ms"], "kernels": r["kernels"]}
                              for c, r in profiled["cases"].items()
                              if c.startswith(key)}
        # held against the plain version at the xlarge fold's shapes too
        rec["xlarge"] = xl_checks[rec["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 rec["xlarge"]["max_abs_err"])
        by_path = {k: r["launches"].get(rec["name"], 0)
                   for k, r in paths.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        if not sum(by_path[k] for k in MAIN_PATHS):
            raise AssertionError(f"{rec['name']} was launched no time on "
                                 f"the main paths {MAIN_PATHS}")
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
