"""The port's walk search (bwtmerge_tpu_torch/ops/walk_torch.py, ra_stream.py)
against the JAX package and the trie oracle, on the CPU.

Same numpy-seeded inputs into both packages; exact equality throughout.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bwtmerge_tpu.formats.sidecar import creads_layout  # noqa: E402
from bwtmerge_tpu.models.build import build_from_reads  # noqa: E402
from bwtmerge_tpu.models.fmi import FMI  # noqa: E402
from bwtmerge_tpu.ops import walk_jax  # noqa: E402
from bwtmerge_tpu.ops.rank_jax import DeviceFMIndex as JaxIndex  # noqa: E402
from bwtmerge_tpu.ops.search_np import build_rank_array  # noqa: E402
from bwtmerge_tpu_torch.ops import walk_torch  # noqa: E402
from bwtmerge_tpu_torch.ops.ra_stream import blocked_walk  # noqa: E402
from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()

SENT = 2**31 - 1


def _random_reads(rng, n, max_len=30):
    return [rng.integers(1, 6, size=int(rng.integers(1, max_len))
                         ).astype(np.uint8) for _ in range(n)]


def _fmi(reads):
    runs, _ = build_from_reads(reads, backend="numpy")
    return FMI.from_runs(runs)


def _creads_of(reads):
    lens = np.array([len(r) for r in reads], np.uint32)
    flat = np.concatenate([np.asarray(r, np.uint8) for r in reads])
    return creads_layout(lens, flat)


def _indexes(a):
    j = JaxIndex.build(a.runs, a.alpha.counts())
    t = DeviceFMIndex.build(a.runs, a.alpha.counts(), "cpu")
    return j, t


def _trie_ra(a, b):
    return build_rank_array(a.rank_index, a.alpha.C.astype(np.int64),
                            b.rank_index, b.alpha.C.astype(np.int64),
                            a.sequences(), b.sequences())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_build_cplanes_matches_jax(seed):
    r = np.random.default_rng(seed)
    j, t = _indexes(_fmi(_random_reads(r, int(r.integers(3, 40)), 60)))
    want = np.asarray(walk_jax.build_cplanes(j.rec))
    got = walk_torch.build_cplanes(t.rec).numpy()
    np.testing.assert_array_equal(got, want[:got.shape[0]])
    assert got.shape[0] == t.rec.shape[0] * walk_torch.NC


def test_rank_known_char_matches_jax(rng):
    a = _fmi(_random_reads(rng, 12, 60))
    j, t = _indexes(a)
    q = rng.integers(0, a.size() + 1, size=257).astype(np.int32)
    c = rng.integers(1, 6, size=257).astype(np.int32)
    want = np.asarray(walk_jax._rank_known_char(
        walk_jax.build_cplanes(j.rec), j.C, jnp.asarray(q), jnp.asarray(c)))
    got = walk_torch.rank_known_char(walk_torch.build_cplanes(t.rec), t.C,
                                     torch.from_numpy(q), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_walk_emit_matches_jax(seed):
    r = np.random.default_rng(seed)
    a = _fmi(_random_reads(r, int(r.integers(2, 20)), 50))
    creads = _creads_of(_random_reads(r, int(r.integers(2, 30)), 40))
    j, t = _indexes(a)
    e_want, n_want = walk_jax._walk_emit(walk_jax.build_cplanes(j.rec), j.C,
                                         jnp.asarray(creads),
                                         jnp.int32(a.sequences()))
    e_got, n_got = walk_torch.walk_emit(walk_torch.build_walk_planes(t.rec),
                                        t.C, torch.from_numpy(creads),
                                        a.sequences())
    np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_want))
    assert int(n_got) == int(n_want) == int((creads > 0).sum())


def test_walk_emit_rejects_bad_inputs(rng):
    a = _fmi(_random_reads(rng, 4))
    _, t = _indexes(a)
    cpl = walk_torch.build_walk_planes(t.rec)
    creads = torch.from_numpy(_creads_of(_random_reads(rng, 3)))
    with pytest.raises(ValueError):
        walk_torch.walk_emit(cpl.to(torch.int64), t.C, creads, a.sequences())
    with pytest.raises(ValueError):
        walk_torch.walk_emit(cpl, t.C, creads.to(torch.int32), a.sequences())
    with pytest.raises(ValueError):
        walk_torch.walk_emit(cpl, t.C, creads, SENT)
    with pytest.raises(ValueError):       # the narrow planes are not taken
        walk_torch.walk_emit(walk_torch.build_cplanes(t.rec), t.C, creads,
                             a.sequences())
    with pytest.raises(ValueError):       # a start past the table
        walk_torch.walk_emit(cpl, t.C, creads,
                             cpl.shape[0] * walk_torch.SUPER)


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_blocked_walk_equals_trie_oracle(seed, n_blocks):
    r = np.random.default_rng(seed)
    a = _fmi(_random_reads(r, int(r.integers(2, 10))))
    reads_b = _random_reads(r, int(r.integers(2, 10)))
    b = _fmi(reads_b)
    want_v, want_k = _trie_ra(a, b)
    _, t = _indexes(a)
    ra = blocked_walk(t, walk_torch.build_walk_planes(t.rec),
                      _creads_of(reads_b),
                      n_blocks, a.sequences())
    assert len(ra.blocks) == min(n_blocks, len(reads_b))
    for blk in ra.blocks:                       # each block sorted-unique
        assert (np.diff(blk.values.numpy()) > 0).all()
    got_v, got_k = ra.finish()
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_k, want_k)
    assert ra.n_runs >= got_v.size


def test_root_run_collision_is_summed():
    # No read of A ends in 1, so rank_A(a_sequences, 1) = 0 and a read of B
    # ending in 1 emits exactly a_sequences = C_A[1] at its first step.
    reads_a = [np.array([1, 3, 2], np.uint8), np.array([4, 2], np.uint8),
               np.array([2, 2, 5], np.uint8)]
    reads_b = [np.array([2, 1], np.uint8), np.array([3, 3, 1], np.uint8),
               np.array([4], np.uint8)]
    a, b = _fmi(reads_a), _fmi(reads_b)
    _, t = _indexes(a)
    cpl = walk_torch.build_walk_planes(t.rec)
    creads = _creads_of(reads_b)
    emits, _ = walk_torch.walk_emit(cpl, t.C, torch.from_numpy(creads),
                                    a.sequences())
    assert (emits.numpy() == a.sequences()).sum() == 2     # two collisions
    values, counts = walk_torch.walk_runs(cpl, t.C, torch.from_numpy(creads),
                                          a.sequences(), len(reads_b))
    v, k = values.numpy(), counts.numpy()
    assert (np.diff(v) > 0).all()
    assert k[v == a.sequences()].tolist() == [len(reads_b) + 2]
    want_v, want_k = _trie_ra(a, b)
    np.testing.assert_array_equal(v, want_v)
    np.testing.assert_array_equal(k, want_k)


# -- the wide planes (one 32-byte row per 224 positions and character) --------

WIDE_SIZES = [1, 223, 224, 225, 447, 448, 3000]


def _random_tables(size, seed):
    """Both packages' indexes over `size` random symbols 0..5 (the walk's
    step is defined on any symbol string, not only on a BWT)."""
    from bwtmerge_tpu.models.runs import RunArrays

    r = np.random.default_rng(seed)
    runs = RunArrays.from_values(r.integers(0, 6, size=size).astype(np.uint8))
    counts = runs.counts(6)
    return (JaxIndex.build(runs, counts),
            DeviceFMIndex.build(runs, counts, "cpu"))


def _bits(words):
    """uint32 bit patterns int32[...] -> bool[..., 32], bit k at index k."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).astype(bool)


@pytest.mark.parametrize("size", WIDE_SIZES)
def test_wide_planes_unpack_to_cplanes(size):
    _, t = _random_tables(size, size)
    nblk = t.rec.shape[0]
    narrow = walk_torch.build_cplanes(t.rec).numpy().reshape(nblk, 5, 2)
    wide = walk_torch.build_walk_planes_plain(t.rec).numpy()
    n_sb = -(-nblk // 7)
    assert wide.shape == (n_sb, 5, 8)
    np.testing.assert_array_equal(
        walk_torch.build_walk_planes(t.rec).numpy(), wide)
    # per-position masks, [position, character]
    want = _bits(narrow[:, :, 1]).transpose(0, 2, 1).reshape(nblk * 32, 5)
    got = _bits(wide[:, :, 1:]).transpose(0, 2, 3, 1).reshape(n_sb * 224, 5)
    np.testing.assert_array_equal(got[: nblk * 32], want)
    assert not got[nblk * 32:].any()
    np.testing.assert_array_equal(wide[:, :, 0], narrow[::7, :, 0])


@pytest.mark.parametrize("size", WIDE_SIZES)
def test_wide_walk_matches_jax_at_super_block_edges(size):
    # every lane of one walk starts at a0: each super-block's first and
    # last positions, their neighbours, and a0 = size
    j, t = _random_tables(size, 100 + size)
    r = np.random.default_rng(size)
    creads = r.integers(0, 6, size=(6, 40)).astype(np.int8)
    creads[0, :5] = np.arange(1, 6)          # every character at a0 itself
    cpl_j = walk_jax.build_cplanes(j.rec)
    planes = walk_torch.build_walk_planes(t.rec)
    edges = {0, size}
    for e in range(0, size + 225, 224):
        edges.update(x for x in (e - 1, e, e + 1, e + 31, e + 32)
                     if 0 <= x <= size)
    for a0 in sorted(edges):
        e_want, n_want = walk_jax._walk_emit(cpl_j, j.C, jnp.asarray(creads),
                                             jnp.int32(a0))
        e_got, n_got = walk_torch.walk_emit(planes, t.C,
                                            torch.from_numpy(creads), a0)
        np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_want),
                                      err_msg=f"a0 = {a0}")
        assert int(n_got) == int(n_want)


def test_rank_wide_matches_rank_known_char(rng):
    _, t = _random_tables(5000, 7)
    q = torch.from_numpy(rng.integers(0, 5001, size=999))
    c = torch.from_numpy(rng.integers(1, 6, size=999))
    want = walk_torch.rank_known_char(walk_torch.build_cplanes(t.rec), t.C,
                                      q, c)
    got = walk_torch.rank_wide(walk_torch.build_walk_planes(t.rec), t.C, q, c)
    assert torch.equal(got, want)
