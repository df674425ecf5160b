"""The port's FM-index and streamed probe (bwtmerge_tpu_torch/ops/rank_torch.py,
rank_streamed.py, convert.py) against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages and every result
must be exactly equal (all quantities are integers).  The Pallas probe runs
in interpret mode, as tests/test_pallas.py runs it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.ops import rank_jax, rank_pallas  # noqa: E402
from bwtmerge_tpu.utils.alphabet import Alphabet  # noqa: E402
from bwtmerge_tpu_torch import kernels  # noqa: E402
from bwtmerge_tpu_torch.convert import index_from_arrays  # noqa: E402
from bwtmerge_tpu_torch.ops import rank_streamed, rank_torch  # noqa: E402

SENT = 2**31 - 1


def _collection(seed):
    """Per seed: random reads, plus the edge shapes the layout has to get
    right (size a multiple of 32; single-symbol and empty reads)."""
    r = np.random.default_rng(seed if isinstance(seed, int) else 9)
    if seed == "mult32":
        return [r.integers(1, 6, size=15) for _ in range(4)]   # 4 * 16 = 64
    if seed == "tiny":
        return [np.array([3]), np.zeros(0, np.int64), np.array([1]),
                np.zeros(0, np.int64), np.array([5, 5])]
    return oracle.random_collection(r, int(r.integers(5, 40)), 1, 120)


def _pair(seed):
    runs = oracle.build_bwt(_collection(seed))
    j = rank_jax.DeviceFMIndex.build(runs, runs.counts(6))
    t = rank_torch.DeviceFMIndex.build(runs, runs.counts(6), "cpu")
    return j, t, runs


SEEDS = [0, 1, 2, 3, "mult32", "tiny"]


@pytest.fixture(scope="module")
def pair():
    return _pair(5)


@pytest.mark.parametrize("seed", SEEDS)
def test_rec_and_C_match_jax(seed):
    j, t, runs = _pair(seed)
    nblk = runs.size() // 32 + 1
    assert t.rec.shape == (nblk, 16)
    np.testing.assert_array_equal(t.rec.numpy(), np.asarray(j.rec)[:nblk])
    np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
    assert (t.size, t.n_runs) == (j.size, j.n_runs)


@pytest.mark.parametrize("seed", SEEDS)
def test_queries_match_jax(seed):
    j, t, runs = _pair(seed)
    rng = np.random.default_rng(11)
    n = runs.size()
    q = rng.integers(0, n + 1, size=300).astype(np.int32)
    q[:2] = (0, n)
    c = rng.integers(0, 6, size=300).astype(np.int32)
    np.testing.assert_array_equal(t.ranks_all(torch.from_numpy(q)).numpy(),
                                  np.asarray(j.ranks_all(jnp.asarray(q))))
    np.testing.assert_array_equal(
        t.rank(torch.from_numpy(q), torch.from_numpy(c)).numpy(),
        np.asarray(j.rank(jnp.asarray(q), jnp.asarray(c))))
    qa = q[q < n]                          # positions holding a symbol
    for got, want in zip(t.inverse_select(torch.from_numpy(qa)),
                         j.inverse_select(jnp.asarray(qa))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.access(torch.from_numpy(qa)).numpy(),
                                  np.asarray(j.access(jnp.asarray(qa))))
    for got, want in zip(t.LF_step(torch.from_numpy(qa)),
                         j.LF_step(jnp.asarray(qa))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_index_from_arrays_gives_same_answers(pair):
    j, t, runs = pair
    got = index_from_arrays(np.asarray(j.rec), np.asarray(j.C), j.size,
                            j.n_runs, device="cpu")
    np.testing.assert_array_equal(got.rec.numpy(), t.rec.numpy())
    np.testing.assert_array_equal(got.C.numpy(), t.C.numpy())
    q = np.arange(runs.size() + 1, dtype=np.int32)
    np.testing.assert_array_equal(got.ranks_all(torch.from_numpy(q)).numpy(),
                                  np.asarray(j.ranks_all(jnp.asarray(q))))
    with pytest.raises(ValueError):
        index_from_arrays(np.asarray(j.rec)[:1], np.asarray(j.C), j.size,
                          device="cpu")


@pytest.mark.parametrize("seed", [0, 1, "mult32", "tiny"])
def test_plain_probe_matches_pallas(seed):
    j, t, runs = _pair(seed)
    n = runs.size()
    rng = np.random.default_rng(12)
    q = np.sort(rng.integers(0, n + 1, size=200)).astype(np.int32)
    q[-1] = n                                              # q == size
    q = np.concatenate([q, np.full(40, SENT, np.int32)])   # sentinel tail
    want = np.asarray(rank_pallas.streamed_probe(j.rec, jnp.asarray(q),
                                                 interpret=True))
    got = rank_streamed.streamed_probe(t.rec, torch.from_numpy(q), n).numpy()
    np.testing.assert_array_equal(got[:9, :200], want[:9, :200])
    assert got[8, 199] == rank_torch.SIGMA                 # pad symbol
    assert not got[9:].any() and not got[:, 200:].any()


def test_probe_empty_and_all_sentinel_batches(pair):
    _, t, runs = pair
    empty = rank_streamed.streamed_probe(
        t.rec, torch.zeros(0, dtype=torch.int32), runs.size())
    assert empty.shape == (16, 0)
    sent = rank_streamed.streamed_probe(
        t.rec, torch.full((64,), SENT, dtype=torch.int32), runs.size())
    assert sent.shape == (16, 64) and not sent.any()


def test_probe_wrapper_rejects_bad_inputs(pair):
    _, t, runs = pair
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        rank_streamed.streamed_probe(t.rec.to(torch.int64), q, runs.size())
    with pytest.raises(ValueError):
        rank_streamed.streamed_probe(t.rec, q.to(torch.int64), runs.size())
    with pytest.raises(ValueError):
        rank_streamed.streamed_probe(t.rec, q, 32 * t.rec.shape[0])


def test_streamed_ranks_match_gather(pair):
    j, t, runs = pair
    rng = np.random.default_rng(13)
    q = rng.integers(0, runs.size() + 1, size=500).astype(np.int32)
    want = np.asarray(j.ranks_all(jnp.asarray(q)))
    got = rank_streamed.ranks_all_unsorted(t, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    qs = np.sort(q)
    np.testing.assert_array_equal(
        rank_streamed.streamed_ranks_all(t, torch.from_numpy(qs)).numpy(),
        np.asarray(j.ranks_all(jnp.asarray(qs))))


def test_backward_searches_match_jax(pair):
    j, t, _ = pair
    rng = np.random.default_rng(14)
    q, max_len = 128, 12
    pats = rng.integers(1, 6, size=(q, max_len)).astype(np.int32)
    lens = rng.integers(1, max_len + 1, q).astype(np.int32)
    sp_w, ep_w = rank_jax.backward_search(j, jnp.asarray(pats),
                                          jnp.asarray(lens), max_len)
    sp_s, ep_s = rank_pallas.backward_search_streamed(
        j, jnp.asarray(pats), jnp.asarray(lens), max_len, interpret=True)
    for fn in (rank_torch.backward_search,
               rank_streamed.backward_search_streamed):
        sp, ep = fn(t, torch.from_numpy(pats), torch.from_numpy(lens),
                    max_len)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_w))
        np.testing.assert_array_equal(ep.numpy(), np.asarray(ep_w))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_s))
        np.testing.assert_array_equal(ep.numpy(), np.asarray(ep_s))


def _patterns(seqs, rng, n):
    comp2char = Alphabet().comp2char
    out = []
    for k in range(n):
        s = seqs[int(rng.integers(len(seqs)))]
        if k % 3 == 0 or s.size < 2:           # absent-ish random patterns
            p = rng.integers(1, 5, size=int(rng.integers(1, 9)))
        else:
            a = int(rng.integers(0, s.size - 1))
            p = s[a:a + int(rng.integers(1, 9))]
        out.append(bytes(comp2char[p]).decode())
    return out


@pytest.mark.parametrize("n", [50, 1 << 14])
def test_batch_count_matches_jax(n):
    seqs = _collection(6)
    runs = oracle.build_bwt(seqs)
    j = rank_jax.DeviceFMIndex.build(runs, runs.counts(6))
    t = rank_torch.DeviceFMIndex.build(runs, runs.counts(6), "cpu")
    pats = _patterns(seqs, np.random.default_rng(15), n)
    c2c = Alphabet().char2comp
    want = rank_jax.batch_count(j, pats, c2c)
    got = rank_torch.batch_count(t, pats, c2c)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.sum() > 0
    # the bytes/array forms encode to the same comps as the str fast path
    mixed = [p.encode() if k % 2 else c2c[np.frombuffer(p.encode(), np.uint8)]
             for k, p in enumerate(pats[:40])]
    np.testing.assert_array_equal(rank_torch.batch_count(t, mixed, c2c),
                                  want[:40])


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runs = oracle.build_bwt(_collection(0))
    with pytest.raises(RuntimeError, match="cuda"):
        rank_torch.DeviceFMIndex.build(runs, runs.counts(6), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        kernels.resolve_device("cuda")


def test_size_limit_refused():
    class _Huge:
        n_runs = 1

        @staticmethod
        def size():
            return 2**31 - 1

    with pytest.raises(ValueError, match="int32"):
        rank_torch.DeviceFMIndex.build(_Huge, np.zeros(6, np.int64), "cpu")
