"""The port's device read decode (bwtmerge_tpu_torch/ops/decode_torch.py)
against the JAX package's (bwtmerge_tpu/ops/walk_jax.py), on the CPU.

Same numpy-seeded collections into both packages; exact equality of the
decoded walk layout, of the read-count result and of the cap overflow.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from bwtmerge_tpu.formats.sidecar import creads_layout  # noqa: E402
from bwtmerge_tpu.models.build import build_from_reads  # noqa: E402
from bwtmerge_tpu.models.fmi import FMI  # noqa: E402
from bwtmerge_tpu.ops import walk_jax  # noqa: E402
from bwtmerge_tpu.ops.rank_jax import DeviceFMIndex as JaxIndex  # noqa: E402
from bwtmerge_tpu_torch.ops import decode_torch  # noqa: E402
from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex  # noqa: E402
from test_torch_kfold import within  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()


def _reads(rng, n, max_len, long_reads=()):
    """n reads of lengths 1..max_len-1 (length-1 reads included), plus
    reads of the given lengths at random places."""
    reads = [rng.integers(1, 6, size=int(rng.integers(1, max_len))
                          ).astype(np.uint8) for _ in range(n)]
    reads[0] = np.array([int(rng.integers(1, 6))], np.uint8)
    for length in long_reads:
        reads.insert(int(rng.integers(0, len(reads) + 1)),
                     rng.integers(1, 6, size=length).astype(np.uint8))
    return reads


def _indexes(reads):
    runs, _ = build_from_reads(reads, backend="numpy")
    f = FMI.from_runs(runs)
    return (f, JaxIndex.build(f.runs, f.alpha.counts()),
            DeviceFMIndex.build(f.runs, f.alpha.counts(), "cpu"))


def _layout(reads):
    lens = np.array([r.size for r in reads], np.uint32)
    return creads_layout(lens, np.concatenate(reads))


@pytest.mark.parametrize("seed,n,max_len", [(1, 1, 2), (2, 40, 12),
                                            (3, 300, 70), (4, 90, 200)])
def test_decode_creads_matches_jax(seed, n, max_len):
    r = np.random.default_rng(seed)
    reads = _reads(r, n, max_len)
    f, j, t = _indexes(reads)
    want = walk_jax.decode_creads(j, f.sequences(), f.size())
    got = within(60, decode_torch.decode_creads, t, f.sequences(), f.size())
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    # the decode recovers the reads in BWT order: the sidecar layout of the
    # collection (endmarker k belongs to read k)
    np.testing.assert_array_equal(got, _layout(reads))


@pytest.mark.parametrize("slab", [3, 7, 1 << 22])
def test_decode_creads_dev_matches_jax_in_slabs(monkeypatch, slab):
    r = np.random.default_rng(5)
    reads = _reads(r, 61, 40)
    f, j, t = _indexes(reads)
    monkeypatch.setattr(walk_jax, "DECODE_SLAB_LANES", slab)
    monkeypatch.setattr(decode_torch, "DECODE_SLAB_LANES", slab)
    want, want_n = walk_jax.decode_creads_dev(j, f.sequences(), f.size())
    got, got_n = within(60, decode_torch.decode_creads_dev, t,
                        f.sequences(), f.size())
    assert got_n == want_n == f.sequences()
    assert got.shape[1] == f.sequences()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want)[:, :f.sequences()])


@pytest.mark.parametrize("cap,long_len", [(128, 200), (100, 90), (100, 110),
                                          (64, 64), (64, 63)])
def test_decode_cap_overflow_matches_jax(cap, long_len):
    # the caps double in powers of two from near the average read length;
    # None once a cap of max_len_cap or more still leaves a lane alive
    r = np.random.default_rng(cap + long_len)
    reads = _reads(r, 50, 6, long_reads=[long_len])
    f, j, t = _indexes(reads)
    for jax_fn, port_fn in ((walk_jax.decode_creads,
                             decode_torch.decode_creads),
                            (walk_jax.decode_creads_dev,
                             decode_torch.decode_creads_dev)):
        want = jax_fn(j, f.sequences(), f.size(), max_len_cap=cap)
        got = port_fn(t, f.sequences(), f.size(), max_len_cap=cap)
        assert (got is None) == (want is None), (port_fn.__name__, got)
        if got is not None:
            g = got if isinstance(got, np.ndarray) else got[0].numpy()
            w = np.asarray(want if isinstance(want, np.ndarray) else want[0])
            np.testing.assert_array_equal(g, w[:, :f.sequences()])
            assert g.shape[0] == long_len


@pytest.mark.parametrize("lane0,width", [(0, 1), (5, 7), (31, 2), (32, 9),
                                         (70, 30)])
def test_decode_lane_slab_matches_jax_step(lane0, width):
    # one slab of lanes at an offset, into a column slice of a wider
    # buffer: the same rows as the JAX device decode of that slab
    r = np.random.default_rng(9)
    reads = _reads(r, 80, 30)
    f, j, t = _indexes(reads)
    cap = 16                          # some reads outlive it
    want, want_alive = walk_jax.decode_creads_device(
        j, jax.numpy.zeros((cap, width), jax.numpy.int8),
        jax.numpy.int32(lane0))
    buf = torch.zeros((cap, width + 4), dtype=torch.int8)
    alive = decode_torch.decode_creads_device(t, buf[:, 2:2 + width], lane0)
    np.testing.assert_array_equal(buf[:, 2:2 + width].numpy(),
                                  np.asarray(want))
    assert int(alive) == int(want_alive)
    assert not buf[:, :2].any() and not buf[:, 2 + width:].any()


def test_decode_wrapper_rejects_bad_buffers():
    r = np.random.default_rng(10)
    _, _, t = _indexes(_reads(r, 10, 8))
    with pytest.raises(ValueError, match="int8"):
        decode_torch.decode_creads_device(
            t, torch.zeros((4, 10), dtype=torch.int32))
    with pytest.raises(ValueError, match="negative"):
        decode_torch.decode_creads_device(
            t, torch.zeros((4, 10), dtype=torch.int8), -1)


def test_decode_no_reads():
    r = np.random.default_rng(11)
    _, _, t = _indexes(_reads(r, 3, 4))
    assert decode_torch.decode_creads(t, 0, 0).shape == (0, 0)
    dev, n = decode_torch.decode_creads_dev(t, 0, 0)
    assert n == 0 and dev.shape == (1, 0)


# -- the decode rows (one 32-byte row per block) -------------------------------


@pytest.mark.parametrize("seed,n,max_len", [(12, 1, 2), (13, 40, 12),
                                            (14, 200, 70)])
def test_decode_rows_unpack_to_the_record_table(seed, n, max_len):
    from bwtmerge_tpu_torch.ops.rank_torch import unpack_symbols

    r = np.random.default_rng(seed)
    _, _, t = _indexes(_reads(r, n, max_len))
    rows = decode_torch.build_decode_rows_plain(t.rec)
    assert rows.dtype == torch.int32
    assert rows.shape == (t.rec.shape[0], 8)
    assert torch.equal(decode_torch.build_decode_rows(t.rec), rows)
    assert torch.equal(rows[:, :5], t.rec[:, 1:6])          # occ of 1..5
    planes = rows[:, 5:].numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (planes[:, :, None] >> np.arange(32)) & 1        # [NBLK, 3, 32]
    syms = bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
    np.testing.assert_array_equal(syms,
                                  unpack_symbols(t.rec[:, 8:]).numpy())


@pytest.mark.parametrize("seed,n,max_len", [(15, 1, 2), (16, 40, 12),
                                            (17, 200, 70)])
def test_decode_rows_step_matches_lf_step_everywhere(seed, n, max_len):
    r = np.random.default_rng(seed)
    f, j, t = _indexes(_reads(r, n, max_len))
    p = torch.arange(f.size())
    lf, sym = decode_torch.decode_rows_step(
        decode_torch.build_decode_rows(t.rec), t.C, p)
    want_lf, want_sym = t.LF_step(p)
    jax_lf, jax_sym = j.LF_step(jax.numpy.arange(f.size(),
                                                 dtype=jax.numpy.int32))
    np.testing.assert_array_equal(want_sym.numpy(), np.asarray(jax_sym))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jax_sym))
    walked = sym.numpy() > 0          # a lane dies at an endmarker
    assert walked.sum() == f.size() - f.sequences()
    np.testing.assert_array_equal(lf.numpy()[walked],
                                  np.asarray(jax_lf)[walked])
    np.testing.assert_array_equal(lf.numpy()[walked],
                                  want_lf.numpy()[walked])
