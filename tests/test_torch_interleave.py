"""The port's interleaves on the CPU: the device interleave
(bwtmerge_tpu_torch/ops/interleave_torch.py) against interleave_jax and
interleave_np on equal inputs, MergeConfig(interleave="device") against
the native chain, and the range-parallel host interleave
(models/parallel_merge.py) byte-identical to the serial chain, as
tests/test_merge.py::TestParallelInterleave holds the original.  Exact
equality throughout.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.models.runs import RunArrays as JRuns  # noqa: E402
from bwtmerge_tpu.ops import interleave_jax as j_il  # noqa: E402
from bwtmerge_tpu_torch import MergeConfig, merge_fmi  # noqa: E402
from bwtmerge_tpu_torch.formats.streaming import write_bwt_stream  # noqa: E402
from bwtmerge_tpu_torch.models.fmi import FMI  # noqa: E402
from bwtmerge_tpu_torch.models.parallel_merge import (  # noqa: E402
    interleave_stream_chunks_parallel)
from bwtmerge_tpu_torch.models.runs import RunArrays  # noqa: E402
from bwtmerge_tpu_torch.native import interleave_stream_chunks  # noqa: E402
from bwtmerge_tpu_torch.ops import interleave_np as p_np  # noqa: E402
from bwtmerge_tpu_torch.ops import interleave_torch as p_il  # noqa: E402
from bwtmerge_tpu_torch.ops import search_np  # noqa: E402
from bwtmerge_tpu_torch.parallel.distributed import (  # noqa: E402
    coalesce_run_chunks)
from bwtmerge_tpu_torch.utils.alphabet import Alphabet  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()


def _pair(seed, n_a=40, n_b=35, lo=10, hi=90):
    """(FMI a, FMI b, rank array values, counts, the two collections)."""
    r = np.random.default_rng(seed)
    a_seqs = oracle.random_collection(r, n_a, lo, hi)
    b_seqs = oracle.random_collection(r, n_b, lo, hi)
    ra_, rb_ = oracle.build_bwt(a_seqs), oracle.build_bwt(b_seqs)
    fa = FMI.from_runs(RunArrays(ra_.syms, ra_.lens))
    fb = FMI.from_runs(RunArrays(rb_.syms, rb_.lens))
    rv, rc = search_np.build_rank_array(
        fa.rank_index, fa.alpha.C.astype(np.int64),
        fb.rank_index, fb.alpha.C.astype(np.int64),
        fa.sequences(), fb.sequences())
    return fa, fb, rv, rc, (a_seqs, b_seqs)


def _same(got, want):
    return (np.array_equal(got.syms, want.syms)
            and np.array_equal(got.lens, want.lens))


@pytest.mark.parametrize("seed,shape", [(1, (40, 35, 10, 90)),
                                        (2, (3, 50, 1, 8)),
                                        (3, (50, 1, 1, 30)),
                                        (4, (12, 12, 40, 41))])
def test_interleave_torch_matches_jax_and_numpy(seed, shape):
    fa, fb, rv, rc, cols = _pair(seed, *shape)
    stats = {}
    got = p_il.interleave_torch(fa.runs, fb.runs, rv, rc, "cpu", stats)
    want = j_il.interleave_jax(JRuns(fa.runs.syms, fa.runs.lens),
                               JRuns(fb.runs.syms, fb.runs.lens), rv, rc)
    assert _same(got, want)
    assert got.syms.dtype == np.uint8 and got.lens.dtype == np.int64
    assert _same(got, p_np.interleave(fa.runs, fb.runs, rv, rc))
    assert got == oracle.merge_collections(list(cols))
    assert got.is_maximal()
    assert set(stats) == {"interleave_s", "rle_s"}


def test_interleave_torch_device_programs():
    import torch

    fa, fb, rv, rc, _ = _pair(5)
    a, b = fa.runs.decode(), fb.runs.decode()
    out = p_il._interleave_decoded(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(rv), torch.from_numpy(rc))
    import jax.numpy as jnp

    want = j_il._interleave_decoded(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(rv, jnp.int32),
                                    jnp.asarray(rc, jnp.int32), a.size + b.size)
    assert out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), np.asarray(want))
    syms, ends, n_runs = p_il._rle_encode_device(out)
    j_syms, j_ends, j_n = j_il._rle_encode_device(want, a.size + b.size)
    assert n_runs == int(j_n) == syms.numel() == ends.numel()
    assert np.array_equal(syms.numpy(), np.asarray(j_syms[:n_runs]))
    assert np.array_equal(ends.numpy(), np.asarray(j_ends[:n_runs]))
    one = p_il._rle_encode_device(torch.tensor([3], dtype=torch.uint8))
    assert one[0].tolist() == [3] and one[1].tolist() == [1] and one[2] == 1


def test_interleave_torch_empty_sides():
    fa, fb, rv, rc, _ = _pair(6, 8, 6, 5, 40)
    empty = RunArrays.empty()
    none = np.zeros(0, np.int64)
    assert _same(p_il.interleave_torch(fa.runs, empty, none, none, "cpu"),
                 fa.runs)
    got = p_il.interleave_torch(empty, fb.runs, np.array([0]),
                                np.array([fb.size()]), "cpu")
    assert _same(got, fb.runs)
    assert p_il.interleave_torch(empty, empty, none, none, "cpu").n_runs == 0


@pytest.mark.parametrize("how", ["short", "long", "beyond_a", "negative",
                                 "negative_count", "descending", "lengths"])
def test_bad_rank_array_raises_value_error(how):
    fa, fb, rv, rc, _ = _pair(7, 10, 8, 5, 30)
    rv, rc = rv.copy(), rc.copy()
    if how == "short":
        rc[-1] -= 1
    elif how == "long":
        rc[-1] += 1
    elif how == "beyond_a":
        rv[-1] = fa.size() + 1
    elif how == "negative":
        rv[0] = -1
    elif how == "negative_count":
        rc[0] -= rc[0] + 1
        rc[-1] += fb.size() - rc.sum()
    elif how == "descending":
        rv[0], rv[1] = rv[1], rv[0]
    else:
        rv = rv[:-1]
    with pytest.raises(ValueError):
        p_il.interleave_torch(fa.runs, fb.runs, rv, rc, "cpu")


def test_interleave_offsets():
    _, fb, rv, rc, _ = _pair(8)
    for g, w in zip(p_il.interleave_offsets(rv, rc, 0),
                    j_il.interleave_offsets(rv, rc, 0)):
        assert np.array_equal(g, w) and g.dtype == w.dtype


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("seed", [11, 12])
def test_merge_config_interleave_device_equals_native(tmp_path, seed, backend):
    fa, fb, _, _, cols = _pair(seed)
    kw = dict(device="cpu", backend=backend, temp_dir=str(tmp_path))
    native = merge_fmi(fa, fb, MergeConfig(interleave="native", **kw))
    calls = []
    real = p_il.interleave_torch
    p_il.interleave_torch = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        device = merge_fmi(fa, fb, MergeConfig(interleave="device", **kw))
    finally:
        p_il.interleave_torch = real
    assert calls == [1]
    assert _same(device.runs, native.runs)
    assert np.array_equal(device.alpha.C, native.alpha.C)
    assert device.runs == oracle.merge_collections(list(cols))


def test_merge_config_rejects_unknown_interleave_and_backend():
    with pytest.raises(ValueError, match="interleave"):
        MergeConfig(device="cpu", interleave="host").sanitize()
    with pytest.raises(ValueError, match="backend"):
        MergeConfig(device="cpu", backend="jax").sanitize()


def test_spilled_ladder_streams_even_with_interleave_device(tmp_path,
                                                            monkeypatch):
    # a ladder that spilled must stream through the native interleave
    from bwtmerge_tpu_torch.models import spill

    fa, fb, _, _, cols = _pair(13)
    calls = []
    spilled = []
    real_spill = spill.RankArraySpill._spill
    monkeypatch.setattr(spill.RankArraySpill, "_spill",
                        lambda self: spilled.append(1) or real_spill(self))
    real = p_il.interleave_torch
    p_il.interleave_torch = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        cfg = MergeConfig(device="cpu", backend="numpy", interleave="device",
                          temp_dir=str(tmp_path), run_buffer_runs=64,
                          merge_buffers=2, thread_buffer_mb=0,
                          sequence_blocks=7)
        merged = merge_fmi(fa, fb, cfg)
    finally:
        p_il.interleave_torch = real
    assert spilled and not calls
    assert merged.runs == oracle.merge_collections(list(cols))
    assert not list(tmp_path.iterdir())          # spill files consumed


# -- the range-parallel host interleave -----------------------------------------


@pytest.mark.parametrize("fmt", ["sga", "native"])
def test_parallel_interleave_byte_identity(tmp_path, fmt):
    fa, fb, rv, rc, _ = _pair(21)
    alpha = Alphabet.from_counts(fa.alpha.counts().astype(np.int64)
                                 + fb.alpha.counts().astype(np.int64))

    def chunks(step):
        for s in range(0, rv.size, step):
            yield rv[s:s + step], rc[s:s + step]

    want = str(tmp_path / f"serial.{fmt}")
    write_bwt_stream(want, fmt, interleave_stream_chunks(
        fa.runs, fb.runs, chunks(1 << 20)), alpha)
    # the original's chain writes the same file
    from bwtmerge_tpu.formats.streaming import write_bwt_stream as j_write
    from bwtmerge_tpu.models.parallel_merge import (
        interleave_stream_chunks_parallel as j_parallel)
    from bwtmerge_tpu.parallel.distributed import (
        coalesce_run_chunks as j_coalesce)
    from bwtmerge_tpu.utils.alphabet import Alphabet as JAlphabet

    j_out = str(tmp_path / f"jax.{fmt}")
    j_write(j_out, fmt, j_coalesce(j_parallel(
        JRuns(fa.runs.syms, fa.runs.lens), JRuns(fb.runs.syms, fb.runs.lens),
        chunks(64), workers=3)), JAlphabet.from_counts(alpha.counts()))
    with open(want, "rb") as f:
        want_bytes = f.read()
    with open(j_out, "rb") as f:
        assert f.read() == want_bytes
    for step in (7, 64, 1 << 20):
        got = str(tmp_path / f"par_{step}.{fmt}")
        write_bwt_stream(got, fmt, coalesce_run_chunks(
            interleave_stream_chunks_parallel(fa.runs, fb.runs, chunks(step),
                                              workers=3)), alpha)
        with open(got, "rb") as f:
            assert f.read() == want_bytes, (fmt, step)


def test_parallel_interleave_empty_ra():
    # empty B: the drain fragment must still emit all of A
    fa, _, _, _, _ = _pair(22, 8, 2, 5, 40)
    parts = list(coalesce_run_chunks(interleave_stream_chunks_parallel(
        fa.runs, RunArrays.empty(), iter([]), workers=2)))
    got = RunArrays(np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    assert got == fa.runs


def test_parallel_interleave_bad_rank_array_raises():
    fa, fb, rv, rc, _ = _pair(23, 10, 8, 5, 30)
    rc = rc.copy()
    rc[-1] += 5                                  # more than B holds
    with pytest.raises(ValueError):
        list(interleave_stream_chunks_parallel(
            fa.runs, fb.runs, iter([(rv, rc)]), workers=2))


@pytest.mark.parametrize("split", [1, 2])
def test_parallel_interleave_chunk_ending_at_the_size_of_a(split):
    # B holds suffixes past every suffix of A, so the rank array's last
    # value is |A|; a chunk that ends there has consumed A whole.  (The
    # original computes that chunk's range end as |A| + 1 and raises.)
    a = [np.array([1, 2, 1, 2]), np.array([2, 1, 3])]
    b = [np.array([4, 4, 4]), np.array([1, 1])]
    ra_, rb_ = oracle.build_bwt(a), oracle.build_bwt(b)
    fa = FMI.from_runs(RunArrays(ra_.syms, ra_.lens))
    fb = FMI.from_runs(RunArrays(rb_.syms, rb_.lens))
    rv, rc = search_np.build_rank_array(
        fa.rank_index, fa.alpha.C.astype(np.int64),
        fb.rank_index, fb.alpha.C.astype(np.int64),
        fa.sequences(), fb.sequences())
    assert int(rv[-1]) == fa.size()
    parts = list(coalesce_run_chunks(interleave_stream_chunks_parallel(
        fa.runs, fb.runs, iter([(rv[:split], rc[:split]),
                                (rv[split:], rc[split:])]), workers=2)))
    got = RunArrays(np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    assert got == oracle.merge_collections([a, b])
