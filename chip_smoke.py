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
   K1 and K2 at the main path's shapes, K3 (the read decode) on the real
   BWT of 10^6 reads of 1..24 characters plus one of 100, past the 64-row
   cap, with lanes starting at block offsets 0 and 31; the full decode
   must also give back the generated reads;
4. small exact merge: 20k + 10k random 50 bp reads merged by the port on
   the card (in three read blocks) and by bwtmerge_tpu's numpy backend;
   the files must be byte-identical;
5. small exact fold: four pieces (20k, then three of 10k reads, seeds
   21-24) folded by the port on the card, lane-blocked on step 2, against
   bwtmerge_tpu's numpy-backend left fold; byte-identical files;
6. main path, two inputs: bwt_merge A B out -v patterns --device cuda at
   bench.py's medium scale (524k + 262k reads of 50 bp, B with its
   read-text sidecar, 2^18 patterns of 32 bp); it must exit 0 (the -v
   counts agree), the merged symbol counts must equal A's plus B's, and
   K1 and K2 must have launched during the run;
7. main path, k-way fold: bwt_merge P0 P1 P2 P3 out -v patterns --device
   cuda with P0, P1 = A, B above and P2, P3 = 262k-read pieces without
   sidecars (seeds 4 and 5), 67 Mbp over three fold steps; exit 0, merged
   symbol counts equal to the pieces' sum, and K1 >= 1, K2 >= 6 and
   K3 >= 3 launches during the run.

The launch counts are set to 0 just before each main path and read just
after.  The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Fixtures are cached in .smoke_cache/.
The script imports nothing of JAX.
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
K3_READS = 1_000_000
K3_MAX_LEN = 24
K3_LONG = 100
K3_CAP = 64
K1_POSITIONS = 100_000_000
K1_QUERIES = 1 << 20
K1_SENTINELS = 4096
K2_SHAPE = (50, 1 << 20)
N_PATTERNS = 1 << 18
PATTERN_LEN = 32


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
    from bwtmerge_tpu.formats import write_bwt
    from bwtmerge_tpu.formats.sidecar import sidecar_path, write_sidecar
    from bwtmerge_tpu.models.oracle import suffix_array
    from bwtmerge_tpu.models.runs import RunArrays
    from bwtmerge_tpu.utils.alphabet import Alphabet

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


def mixed_text(m: int, seed: int) -> np.ndarray:
    """The decode fixture's text: read k as comp values 1..4 plus m, then
    its endmarker k (so endmarkers sort first, in read order)."""
    ends = np.cumsum(mixed_lengths(m, seed) + 1) - 1
    rng = np.random.default_rng(seed + 1)
    text = rng.integers(1, 5, size=int(ends[-1]) + 1) + m
    text[ends] = np.arange(m)
    return text


def build_mixed_fixture(path: str, m: int, seed: int) -> str:
    """SGA file of the collection BWT of mixed_text(m, seed).  Cached."""
    if os.path.exists(path):
        return path
    from bwtmerge_tpu.formats import write_bwt
    from bwtmerge_tpu.models.oracle import suffix_array
    from bwtmerge_tpu.models.runs import RunArrays
    from bwtmerge_tpu.utils.alphabet import Alphabet

    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = mixed_text(m, seed)
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
        jobs += [("a", build_fixture, os.path.join(medium, "a.sga"),
                  MEDIUM[0], 1, False),
                 ("k3", build_mixed_fixture, os.path.join(
                     CACHE, f"decode_{K3_READS}.sga"), K3_READS, 31),
                 ("b", build_fixture, os.path.join(medium, "b.sga"),
                  MEDIUM[1], 2, True)]
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
    from bwtmerge_tpu.utils.alphabet import Alphabet

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
    from bwtmerge_tpu.native.build import build_library
    from bwtmerge_tpu_torch import kernels

    t0 = time.monotonic()
    kernels.build(force=True)
    t1 = time.monotonic()
    build_library()
    t2 = time.monotonic()
    return {"kernels_s": t1 - t0, "native_s": t2 - t1}


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


def check_kernels(device, n_pos: int, n_q: int, n_sent: int,
                  walk_shape, seed: int = 7) -> list:
    """Each kernel's wrapper against its plain version on the same device
    tensors; exact equality.  Returns the per-kernel records."""
    import torch

    from bwtmerge_tpu_torch.ops.rank_streamed import (streamed_probe,
                                                      streamed_probe_plain)
    from bwtmerge_tpu_torch.ops.walk_torch import (build_cplanes, walk_emit,
                                                   walk_emit_plain)

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
              lambda: streamed_probe_plain(idx.rec, q, idx.size), device)}
    log(f"K1 streamed_probe: {n_pos} positions, {n_q} sorted queries + "
        f"{n_sent} sentinels: equal, {k1['ms']:.4f} ms vs plain "
        f"{k1['plain_ms']:.4f} ms")

    max_len, r = walk_shape
    cpl = build_cplanes(idx.rec)
    lens = torch.randint(1, max_len + 1, (r,), generator=gen, device=device)
    chars = torch.randint(1, 6, (max_len, r), generator=gen, device=device)
    rows = torch.arange(max_len, device=device)[:, None]
    creads = torch.where(rows < lens[None, :], chars, 0).to(torch.int8)
    a0 = int(idx.C[1])
    e_got, n_got = walk_emit(cpl, idx.C, creads, a0)
    e_want, n_want = walk_emit_plain(cpl, idx.C, creads, a0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = int((e_got.to(torch.int64) - e_want.to(torch.int64)).abs().max())
    if not (torch.equal(e_got, e_want) and int(n_got) == int(n_want)):
        raise AssertionError(f"walk_emit differs from its plain version (max "
                             f"abs err {err}, n_live {int(n_got)} vs "
                             f"{int(n_want)})")
    if int(n_got) != int(lens.sum()):
        raise AssertionError("walk_emit n_live is not the creads length sum")
    k2 = {"name": "walk_emit", "route": "cuda",
          "source": "bwtmerge_tpu_torch/csrc/walk.cu",
          "replaces": "bwtmerge_tpu/ops/walk_jax.py:133",
          "max_abs_err": err,
          "ms": time_ms(lambda: walk_emit(cpl, idx.C, creads, a0), device),
          "plain_ms": time_ms(
              lambda: walk_emit_plain(cpl, idx.C, creads, a0), device)}
    log(f"K2 walk_emit: creads {list(creads.shape)}: equal, "
        f"{k2['ms']:.4f} ms vs plain {k2['plain_ms']:.4f} ms")
    return [k1, k2]


def check_decode(device, path: str, m: int = K3_READS, seed: int = 31,
                 cap: int = K3_CAP) -> dict:
    """K3 against decode_creads_plain on the same device tensors, exact:
    every lane at once, then narrow slabs starting at block offsets 0 and
    31 (lane l starts at BWT row l).  The full decode, with its cap
    doubling, must give back the generated reads.  Returns K3's record."""
    import torch

    from bwtmerge_tpu.formats import read_bwt
    from bwtmerge_tpu.formats.sidecar import creads_layout
    from bwtmerge_tpu_torch.ops.decode_torch import (decode_creads,
                                                     decode_creads_device,
                                                     decode_creads_plain)
    from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex

    runs, _, _ = read_bwt(path, "sga")
    idx = DeviceFMIndex.build(runs, runs.counts(6), device)
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

    buf = torch.zeros((cap, m), dtype=torch.int8, device=device)
    rec = {"name": "decode", "route": "cuda",
           "source": "bwtmerge_tpu_torch/csrc/decode.cu",
           "replaces": "bwtmerge_tpu/ops/walk_jax.py:280",
           "max_abs_err": err,
           "ms": time_ms(lambda: decode_creads_device(idx, buf), device),
           "plain_ms": time_ms(lambda: decode_creads_plain(idx, buf), device)}
    log(f"K3 decode: {m} reads ({idx.size} positions), creads [{cap}, {m}]: "
        f"equal, reads recovered, {rec['ms']:.4f} ms vs plain "
        f"{rec['plain_ms']:.4f} ms")
    return rec


def small_merge(device, fixtures: Fixtures, reads=SMALL) -> None:
    """The port on `device` against bwtmerge_tpu's numpy backend: the two
    merged files must be byte-identical.  Three read blocks, so the
    blocks' overlapped copies and their stream merge run too."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu.models import fmi as ref_fmi
    from bwtmerge_tpu.models import merge as ref_merge

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
    ref_merge.merge_fmi_to_file(ref_fmi.load_fmi(a_path, "sga"),
                                ref_fmi.load_fmi(b_path, "sga"), out_ref,
                                "sga", ref_merge.MergeConfig(
                                    backend="numpy", temp_dir=d))
    t2 = time.monotonic()
    with open(out_port, "rb") as f1, open(out_ref, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("small merge: port output differs from the "
                                 "numpy backend's")
    log(f"small merge {reads[0]}+{reads[1]} reads: byte-identical "
        f"(port {t1 - t0:.3f} s, numpy backend {t2 - t1:.3f} s)")


def small_fold(device, fixtures: Fixtures) -> None:
    """The port's k-way fold of four pieces on `device` (the thread chain,
    lane blocking forced on step 2) against bwtmerge_tpu's numpy-backend
    left fold of pairwise merges: the files must be byte-identical."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu.models import fmi as ref_fmi
    from bwtmerge_tpu.models import merge as ref_merge
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
    cfg = ref_merge.MergeConfig(backend="numpy", temp_dir=d)
    acc = ref_fmi.load_fmi(paths[0], "sga")
    for p in paths[1:]:
        acc = ref_merge.merge_fmi(acc, ref_fmi.load_fmi(p, "sga"), cfg)
    ref_fmi.serialize_fmi(acc, out_ref, "sga")
    t2 = time.monotonic()
    with open(out_port, "rb") as f1, open(out_ref, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("small fold: port output differs from the "
                                 "numpy backend's left fold")
    log(f"small fold {'+'.join(str(m) for m, _ in FOLD_SMALL)} reads, step 2 "
        f"in {blocks[0]} lane blocks: byte-identical (port {t1 - t0:.3f} s, "
        f"numpy backend left fold {t2 - t1:.3f} s)")


def run_cli(argv) -> tuple:
    """bwt_merge.main(argv) with its output captured and echoed; the
    kernels' launch counts are set to 0 just before and read just after.
    (exit status, stdout, stderr, launches, wall seconds)"""
    from bwtmerge_tpu_torch import kernels
    from bwtmerge_tpu_torch.cli import bwt_merge

    buf_out, buf_err = io.StringIO(), io.StringIO()
    kernels.reset_launches()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf_out), contextlib.redirect_stderr(buf_err):
        rc = bwt_merge.main(argv)
    wall = time.monotonic() - t0
    counts = kernels.launches()
    sys.stdout.write(buf_out.getvalue())
    sys.stdout.write(buf_err.getvalue())
    return rc, buf_out.getvalue(), buf_err.getvalue(), counts, wall


def phase_times(err: str) -> dict:
    return {k: float(v) for k, v in re.findall(
        r"bwt_merge: (.+?) finished in ([0-9.]+) seconds", err)}


def main_path(device, fixtures: Fixtures, reads=MEDIUM,
              n_patterns=N_PATTERNS) -> dict:
    """bwt_merge A B out -v patterns on `device`; checks and phase times."""
    from bwtmerge_tpu.formats import read_bwt

    a_path, b_path = fixtures.get("a"), fixtures.get("b")
    d = os.path.dirname(a_path)
    pat_path = os.path.join(d, f"patterns_{n_patterns}.txt")
    if not os.path.exists(pat_path):
        write_patterns(pat_path, [reads_of(reads[0], 1),
                                  reads_of(reads[1], 2)], n_patterns, 3)
    log(f"medium fixtures ready {time.monotonic() - fixtures.t0:.1f} s "
        f"after the pool started")
    out = os.path.join(d, "merged.sga")
    rc, std, err, counts, wall = run_cli(
        [a_path, b_path, out, "-i", "sga", "-o", "sga", "-v", pat_path,
         "--device", str(device)])
    if rc != 0:
        raise AssertionError(f"bwt_merge exited {rc}")

    a_runs, _, _ = read_bwt(a_path, "sga")
    b_runs, _, _ = read_bwt(b_path, "sga")
    m_runs, _, _ = read_bwt(out, "sga")
    want = a_runs.counts(6) + b_runs.counts(6)
    if not np.array_equal(m_runs.counts(6), want):
        raise AssertionError("merged symbol counts differ from A + B")
    if min(counts["streamed_probe"], counts["walk_emit"]) < 1:
        raise AssertionError(f"a kernel did not launch on the two-input "
                             f"main path: {counts}")

    phases = phase_times(err)
    b_bases = b_runs.size()
    merge_s = (phases.get("search (rank array)", 0)
               + phases.get("merge (interleave)", 0))
    result = {"launches": counts, "phases_s": phases,
              "verify_s": verify_times(std), "wall_s": wall,
              "b_bases": b_bases,
              "merge_mbases_s": b_bases / 1e6 / max(merge_s, 1e-9)}
    log(f"main path {reads[0]}+{reads[1]} reads, {n_patterns} patterns: "
        f"{json.dumps(result)}")
    return result


def verify_times(out: str) -> list:
    return [float(s) for s in re.findall(
        r"patterns, \d+ occurrences \(([0-9.]+) s", out)]


def fold_path(device, fixtures: Fixtures, n_patterns=N_PATTERNS) -> dict:
    """bwt_merge P0 P1 P2 P3 out -v patterns on `device`: the k-way fold.
    Checks the exit status, the merged symbol counts and the launches."""
    from bwtmerge_tpu.formats import read_bwt

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
    want = {"streamed_probe": 1, "walk_emit": 6, "decode": 3}
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


def main() -> int:
    import torch

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
    with Fixtures() as fixtures:
        records = check_kernels(device, K1_POSITIONS, K1_QUERIES,
                                K1_SENTINELS, K2_SHAPE)
        records.append(check_decode(device, fixtures.get("k3")))
        small_merge(device, fixtures)
        small_fold(device, fixtures)
        paths = {"two_input_merge": main_path(device, fixtures),
                 "kway_fold": fold_path(device, fixtures)}
    for rec in records:
        by_path = {k: r["launches"][rec["name"]] for k, r in paths.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    log(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
