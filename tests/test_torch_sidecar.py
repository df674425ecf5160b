"""B's read text on its way to the walk: the port's sidecar layout
(formats/sidecar.creads_layout) against the JAX package's, and the
block-sampled rank index of the sidecar's gate (ops/rank_np.SparseRankIndex,
its sums now taken in one native pass over the runs) against the eight
passes it replaced, kept here as they were, and against the JAX package's.
The same inputs, made from a seed with numpy, through each; values exactly
equal.
"""

import numpy as np
import pytest

import bwtmerge_tpu.formats.sidecar as j_sidecar
import bwtmerge_tpu.ops.rank_np as j_rank
import bwtmerge_tpu_torch.formats.sidecar as p_sidecar
import bwtmerge_tpu_torch.native as p_native
import bwtmerge_tpu_torch.ops.rank_np as p_rank
from jax_native_once import build_jax_native_once

build_jax_native_once()


def _reads(case, rng):
    """(lengths uint32[R], flat uint8[total]) of one layout case."""
    lengths = {
        "equal": np.full(37, 11),
        "unequal": rng.integers(1, 21, size=40),
        "zero_length_reads": rng.integers(0, 4, size=30) * rng.integers(
            0, 9, size=30),
        "all_zero_length": np.zeros(6),
        "single_read": np.array([7]),
        "no_reads": np.zeros(0),
        "odd_total": np.array([3, 4, 6, 2, 9, 1]),
    }[case].astype(np.uint32)
    return lengths, rng.integers(1, 6, size=int(lengths.sum())).astype(
        np.uint8)


LAYOUT_CASES = ["equal", "unequal", "zero_length_reads", "all_zero_length",
                "single_read", "no_reads", "odd_total"]


@pytest.mark.parametrize("tile_bytes", [None, 40])
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_creads_layout_matches_jax(case, tile_bytes, monkeypatch):
    """Both layouts give the same int8[max(max_len, 1), max(R, 1)] array;
    with 40-byte tiles every case of more than a few reads spans several."""
    if tile_bytes:
        monkeypatch.setattr(p_sidecar, "LAYOUT_TILE_BYTES", tile_bytes)
    lengths, flat = _reads(case, np.random.default_rng(len(case)))
    assert case != "odd_total" or int(lengths.sum()) % 2 == 1
    got = p_sidecar.creads_layout(lengths, flat)
    want = j_sidecar.creads_layout(lengths, flat)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["unequal", "odd_total", "single_read"])
def test_load_creads_through_the_file_matches_jax(tmp_path, case):
    """The sidecar written, hashed, packed by nibbles (an odd total pads the
    last byte) and read back: the same layout from both packages' files."""
    lengths, flat = _reads(case, np.random.default_rng(7))
    jp, pp = str(tmp_path / "j.reads4"), str(tmp_path / "p.reads4")
    j_sidecar.write_sidecar(jp, lengths, flat)
    p_sidecar.write_sidecar(pp, lengths, flat)
    np.testing.assert_array_equal(p_sidecar.load_creads(jp),
                                  j_sidecar.load_creads(pp))


@pytest.mark.parametrize("equal", [True, False])
def test_creads_layout_refuses_lengths_that_miss_the_text(equal):
    """Lengths that do not sum to the characters raise ValueError, which
    FMI.creads turns into a warning and no sidecar, as the JAX package's
    layout does."""
    lengths = np.array([4, 4, 4] if equal else [4, 2, 4], np.uint32)
    flat = np.ones(int(lengths.sum()) + 1, np.uint8)
    for mod in (j_sidecar, p_sidecar):
        with pytest.raises(ValueError):
            mod.creads_layout(lengths, flat)


def _eight_pass(syms, lens, sigma, stride, slab_runs):
    """SparseRankIndex.from_arrays's sums as they were before the native
    pass: slab by slab, np.add.reduceat of the lengths and of each
    symbol's masked lengths, then the running sums."""
    r = syms.size
    nb = max(1, -(-r // stride))
    blk_starts = np.zeros(nb + 1, np.int64)
    blk_occ = np.zeros((nb + 1, sigma), np.int64)
    slab = max(stride, slab_runs // stride * stride)
    for s0 in range(0, r, slab):
        s1 = min(s0 + slab, r)
        cuts = np.arange(0, s1 - s0, stride)
        b0 = s0 // stride + 1
        ls = lens[s0:s1].astype(np.int64)
        blk_starts[b0:b0 + cuts.size] = np.add.reduceat(ls, cuts)
        ss = syms[s0:s1]
        for c in range(sigma):
            blk_occ[b0:b0 + cuts.size, c] = np.add.reduceat(
                np.where(ss == c, ls, 0), cuts)
    np.cumsum(blk_starts, out=blk_starts)
    np.cumsum(blk_occ, axis=0, out=blk_occ)
    return blk_starts, blk_occ


STRIDE = 16


@pytest.mark.parametrize("lens_dtype", [np.int64, np.uint32])
@pytest.mark.parametrize("n_runs", [0, 1, STRIDE - 1, STRIDE, STRIDE + 1,
                                    9 * STRIDE + 3])
def test_sparse_rank_one_pass_matches_eight_passes(n_runs, lens_dtype):
    """blk_starts, blk_occ and inverse_select of the one-pass index equal
    the eight-pass build's (its slabs of 4 * STRIDE runs: 9 * STRIDE + 3
    runs span three) and the JAX package's build."""
    rng = np.random.default_rng(n_runs)
    syms = rng.integers(0, 6, size=n_runs).astype(np.uint8)
    lens = rng.integers(1, 300, size=n_runs).astype(lens_dtype)
    got = p_rank.SparseRankIndex.from_arrays(syms, lens, 6, STRIDE)
    starts, occ = _eight_pass(syms, lens, 6, STRIDE, 4 * STRIDE)
    np.testing.assert_array_equal(got.blk_starts, starts)
    np.testing.assert_array_equal(got.blk_occ, occ)
    assert got.blk_starts.dtype == got.blk_occ.dtype == np.int64
    assert got.lens is lens and got.syms is syms and got.stride == STRIDE
    jax = j_rank.SparseRankIndex.build(
        j_rank.RunArrays(syms, lens.astype(np.int64)), 6, STRIDE)
    np.testing.assert_array_equal(got.blk_starts, jax.blk_starts)
    np.testing.assert_array_equal(got.blk_occ, jax.blk_occ)
    if n_runs:
        old = p_rank.SparseRankIndex(syms, lens, starts, occ, STRIDE)
        pos = rng.integers(0, int(lens.astype(np.int64).sum()), size=200)
        for g, w in zip(got.inverse_select(pos), old.inverse_select(pos)):
            np.testing.assert_array_equal(g, w)


def test_sparse_rank_build_keeps_the_default_stride():
    runs = p_rank.RunArrays(np.array([1, 2, 1], np.uint8),
                            np.array([3, 1, 2], np.int64))
    idx = p_rank.SparseRankIndex.build(runs)
    assert idx.stride == 1 << 12
    np.testing.assert_array_equal(idx.blk_starts, [0, 6])
    np.testing.assert_array_equal(idx.blk_occ[1], [0, 5, 1, 0, 0, 0])


def test_run_block_sums_refuses_what_it_cannot_sum():
    syms, lens = np.zeros(3, np.uint8), np.ones(3, np.int64)
    for stride, sigma in ((4, 257), (4, 0), (0, 6)):
        with pytest.raises(ValueError, match="out of range"):
            p_native.run_block_sums(syms, lens, stride, sigma)
    with pytest.raises(ValueError, match="differ in length"):
        p_native.run_block_sums(syms, lens[:2], 4, 6)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.bool_])
def test_byte_counts_is_bincount_of_the_bytes(dtype):
    """byte_counts counts a 1-byte array as np.bincount counts its values
    cast to uint8 (int8 -1 as 255), non-contiguous input included."""
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, size=(50, 301)).astype(dtype)
    view = a[:, ::3]
    for arr in (a, view):
        want = np.bincount(arr.reshape(-1).astype(np.uint8), minlength=256)
        np.testing.assert_array_equal(p_native.byte_counts(arr), want)
    with pytest.raises(ValueError, match="1-byte"):
        p_native.byte_counts(a.astype(np.int16))
