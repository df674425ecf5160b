#!/usr/bin/env python3
"""Drive the PyTorch port (bwtmerge_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the card's name and power limit, from nvidia-smi;
2. build: the CUDA kernels (csrc/*.cu, one nvcc each, in parallel) and the
   native host library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, compared for exact equality (all integer) and
   timed with CUDA events;
4. small exact merge: 20k + 10k random 50 bp reads merged by the port on
   the card (in three read blocks) and by bwtmerge_tpu's numpy backend;
   the files must be byte-identical;
5. main path: bwt_merge A B out -v patterns --device cuda at bench.py's
   medium scale (524k + 262k reads of 50 bp, B with its read-text
   sidecar, 2^18 patterns of 32 bp); it must exit 0 (the -v counts
   agree), the merged symbol counts must equal A's plus B's, and both
   kernels must have launched during the run.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Fixtures are cached in .smoke_cache/.
The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
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


def small_merge(device, reads=SMALL) -> None:
    """The port on `device` against bwtmerge_tpu's numpy backend: the two
    merged files must be byte-identical.  Three read blocks, so the
    blocks' overlapped copies and their stream merge run too."""
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu.models import fmi as ref_fmi
    from bwtmerge_tpu.models import merge as ref_merge

    d = os.path.join(CACHE, "small")
    a_path = build_fixture(os.path.join(d, f"a_{reads[0]}.sga"), reads[0],
                           11, False)
    b_path = build_fixture(os.path.join(d, f"b_{reads[1]}.sga"), reads[1],
                           12, True)
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


def main_path(device, reads=MEDIUM, n_patterns=N_PATTERNS) -> dict:
    """bwt_merge A B out -v patterns on `device`; checks and phase times."""
    from bwtmerge_tpu.formats import read_bwt
    from bwtmerge_tpu_torch import kernels
    from bwtmerge_tpu_torch.cli import bwt_merge

    d = os.path.join(CACHE, f"medium_{reads[0]}_{reads[1]}")
    t0 = time.monotonic()
    a_path = build_fixture(os.path.join(d, "a.sga"), reads[0], 1, False)
    b_path = build_fixture(os.path.join(d, "b.sga"), reads[1], 2, True)
    pat_path = os.path.join(d, f"patterns_{n_patterns}.txt")
    if not os.path.exists(pat_path):
        write_patterns(pat_path, [reads_of(reads[0], 1),
                                  reads_of(reads[1], 2)], n_patterns, 3)
    log(f"fixtures ready in {time.monotonic() - t0:.1f} s")
    out = os.path.join(d, "merged.sga")

    kernels.reset_launches()
    buf_out, buf_err = io.StringIO(), io.StringIO()
    t1 = time.monotonic()
    with contextlib.redirect_stdout(buf_out), contextlib.redirect_stderr(buf_err):
        rc = bwt_merge.main([a_path, b_path, out, "-i", "sga", "-o", "sga",
                             "-v", pat_path, "--device", str(device)])
    wall = time.monotonic() - t1
    counts = kernels.launches()
    sys.stdout.write(buf_out.getvalue())
    sys.stdout.write(buf_err.getvalue())
    if rc != 0:
        raise AssertionError(f"bwt_merge exited {rc}")

    a_runs, _, _ = read_bwt(a_path, "sga")
    b_runs, _, _ = read_bwt(b_path, "sga")
    m_runs, _, _ = read_bwt(out, "sga")
    want = a_runs.counts(6) + b_runs.counts(6)
    if not np.array_equal(m_runs.counts(6), want):
        raise AssertionError("merged symbol counts differ from A + B")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{counts}")

    text = buf_err.getvalue()
    phases = {k: float(v) for k, v in re.findall(
        r"bwt_merge: (.+?) finished in ([0-9.]+) seconds", text)}
    verify = [float(s) for s in re.findall(
        r"patterns, \d+ occurrences \(([0-9.]+) s", buf_out.getvalue())]
    b_bases = b_runs.size()
    merge_s = (phases.get("search (rank array)", 0)
               + phases.get("merge (interleave)", 0))
    result = {"launches": counts, "phases_s": phases, "verify_s": verify,
              "wall_s": wall, "b_bases": b_bases,
              "merge_mbases_s": b_bases / 1e6 / max(merge_s, 1e-9)}
    log(f"main path {reads[0]}+{reads[1]} reads, {n_patterns} patterns: "
        f"{json.dumps(result)}")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    import bwtmerge_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    builds = build_all()
    log(f"build: kernels {builds['kernels_s']:.2f} s, native host library "
        f"{builds['native_s']:.2f} s")
    records = check_kernels(device, K1_POSITIONS, K1_QUERIES, K1_SENTINELS,
                            K2_SHAPE)
    small_merge(device)
    result = main_path(device)
    for rec in records:
        rec["launches"] = result["launches"][rec["name"]]
    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
