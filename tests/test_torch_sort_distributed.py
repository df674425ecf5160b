"""The port's mesh-distributed sorts and sharded BWT construction
(bwtmerge_tpu_torch/parallel/sort_distributed.py) on the CPU, mirroring the
JAX package's tests/test_sort_distributed.py at mesh sizes 1, 2, 4 and 8 of
CPU entries.  Each JAX function runs once on its 8 virtual CPU devices, in
a module-scoped fixture, and the port's result on the same input must equal
it; the other cases hold the port against the host oracles the JAX tests
use (np.lexsort, oracle.suffix_array, oracle.build_bwt,
models/build.rlo_order).  Sorts whose ties are arbitrary are compared by
keys and by the pairing of keys and payloads.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.models.build import rlo_order  # noqa: E402
from bwtmerge_tpu.parallel import sort_distributed as jsd  # noqa: E402
from bwtmerge_tpu.parallel.mesh import make_mesh  # noqa: E402
from bwtmerge_tpu_torch.parallel import sort_distributed as psd  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()

SIZES = [1, 2, 4, 8]


def _cpu(p):
    return ["cpu"] * p


@pytest.fixture(scope="module")
def jax_ref():
    """One call of each JAX function on its 8 devices, with its input."""
    r = np.random.default_rng(77)
    n = 8 * 64
    sort_in = (r.integers(0, 7, n).astype(np.int32),
               r.integers(0, 5, n).astype(np.int32),
               np.arange(n, dtype=np.int32))
    sample_in = (r.integers(0, 4, n).astype(np.int32),
                 r.integers(0, 10**6, n).astype(np.int32),
                 np.arange(n, dtype=np.int32))
    text = r.integers(0, 6, 200).astype(np.int64)
    col = oracle.random_collection(r, 40, 10, 60)
    seqs = [r.integers(1, 6, r.integers(1, 35)) for _ in range(40)]
    mesh = make_mesh(8)
    return dict(
        sort_in=sort_in, sample_in=sample_in, text=text, col=col, seqs=seqs,
        sort=[np.asarray(x) for x in jsd.sharded_sort(sort_in, 3, mesh=mesh)],
        sample=[np.asarray(x) for x in jsd.sharded_sample_sort(
            sample_in, 3, mesh=mesh)],
        sa=jsd.suffix_array_sharded(text, mesh=mesh),
        bwt=jsd.build_bwt_sharded(col, mesh=mesh),
        rlo=jsd.rlo_order_sharded(seqs, mesh=mesh))


# -- the odd-even network ---------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_network_sorts_blocks(p, rng):
    assert psd._oddeven_rounds(p) == jsd._oddeven_rounds(p)
    s = 8
    blocks = [np.sort(rng.integers(0, 100, s)) for _ in range(p)]
    for pairs in psd._oddeven_rounds(p):
        for lo, hi in pairs:
            merged = np.sort(np.concatenate([blocks[lo], blocks[hi]]))
            blocks[lo], blocks[hi] = merged[:s], merged[s:]
    got = np.concatenate(blocks)
    assert np.array_equal(got, np.sort(got))


# -- sharded_sort -----------------------------------------------------------------


@pytest.mark.parametrize("p", SIZES)
def test_sharded_sort_matches_jax_and_lexsort(jax_ref, p):
    k1, k2, uid = jax_ref["sort_in"]
    out = psd.sharded_sort((k1, k2, uid), num_keys=3, mesh=_cpu(p))
    order = np.lexsort((uid, k2, k1))
    for got, want, jax_got in zip(out, (k1, k2, uid), jax_ref["sort"]):
        assert np.array_equal(got, want[order])
        assert np.array_equal(got, jax_got)


@pytest.mark.parametrize("p", SIZES)
def test_sharded_sort_carries_payloads(rng, p):
    n = p * 64
    k1 = rng.integers(0, 7, n).astype(np.int32)
    k2 = rng.integers(0, 5, n).astype(np.int32)
    uid = np.arange(n, dtype=np.int32)
    payload = rng.integers(0, 1000, n).astype(np.int32)
    got = psd.sharded_sort((k1, k2, uid, payload), num_keys=3, mesh=_cpu(p))
    order = np.lexsort((uid, k2, k1))
    assert np.array_equal(got[3], payload[order])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sharded_sort_rejects_indivisible(p):
    with pytest.raises(ValueError, match="not divisible"):
        psd.sharded_sort((np.zeros(p * 3 + 1, np.int32),), num_keys=1,
                         mesh=_cpu(p))


TIE_MAKERS = {
    "all_equal": lambda rng, n: np.zeros(n, np.int32),
    "two_values": lambda rng, n: (np.arange(n) % 2).astype(np.int32),
    "few_values": lambda rng, n: rng.integers(0, 5, n).astype(np.int32),
    "sparse": lambda rng, n: (rng.integers(0, 2, n)
                              * rng.integers(0, 100, n)).astype(np.int32),
}


@pytest.mark.parametrize("method", ["oddeven", "sample"])
@pytest.mark.parametrize("ties", sorted(TIE_MAKERS))
@pytest.mark.parametrize("p", SIZES)
def test_tied_keys_preserve_payloads(rng, p, ties, method):
    # tied keys straddling a merge-split or a splitter must neither lose
    # nor duplicate payloads
    n = p * 128
    k = TIE_MAKERS[ties](rng, n)
    pay = np.arange(n, dtype=np.int32)
    sort = psd.sharded_sort if method == "oddeven" else psd.sharded_sample_sort
    ks, ps = sort((k, pay), num_keys=1, mesh=_cpu(p))
    assert np.array_equal(ks, np.sort(k))
    assert np.array_equal(np.sort(ps), pay)      # a permutation
    assert np.array_equal(k[ps], ks)             # pairing intact


# -- sharded_sample_sort ----------------------------------------------------------


@pytest.mark.parametrize("p", SIZES)
def test_sample_sort_matches_jax_and_lexsort(jax_ref, p):
    k1, k2, uid = jax_ref["sample_in"]
    out = psd.sharded_sample_sort((k1, k2, uid), num_keys=3, mesh=_cpu(p))
    want = np.lexsort((uid, k2, k1))
    for got, x, jax_got in zip(out, (k1, k2, uid), jax_ref["sample"]):
        assert np.array_equal(got, x[want])
        assert np.array_equal(got, jax_got)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sample_sort_small_shards(rng, p):
    # shards below the sampling regime take the network
    n = p * 4
    k = rng.integers(0, 100, n).astype(np.int32)
    (ks,) = psd.sharded_sample_sort((k,), num_keys=1, mesh=_cpu(p))
    assert np.array_equal(ks, np.sort(k))


# -- suffix_array_sharded ---------------------------------------------------------


@pytest.mark.parametrize("n", [5, 63, 64, 200, 1000])
@pytest.mark.parametrize("p", SIZES)
def test_suffix_array_matches_oracle(rng, p, n):
    text = rng.integers(0, 6, n).astype(np.int64)
    got = psd.suffix_array_sharded(text, mesh=_cpu(p))
    assert got.dtype == np.int64
    assert np.array_equal(got, oracle.suffix_array(text))


@pytest.mark.parametrize("method", ["oddeven", "sample"])
@pytest.mark.parametrize("p", SIZES)
def test_suffix_array_matches_jax(jax_ref, p, method):
    got = psd.suffix_array_sharded(jax_ref["text"], mesh=_cpu(p),
                                   sort_method=method)
    assert np.array_equal(got, jax_ref["sa"])


@pytest.mark.parametrize("method", ["oddeven", "sample"])
@pytest.mark.parametrize("p", SIZES)
def test_suffix_array_repetitive_text(rng, p, method):
    text = np.repeat(rng.integers(0, 2, 20), 30).astype(np.int64)
    got = psd.suffix_array_sharded(text, mesh=_cpu(p), sort_method=method)
    assert np.array_equal(got, oracle.suffix_array(text))


@pytest.mark.parametrize("n", [200, 1000])
@pytest.mark.parametrize("p", [2, 8])
def test_suffix_array_sample_rounds_match_oracle(rng, p, n):
    text = rng.integers(0, 6, n).astype(np.int64)
    got = psd.suffix_array_sharded(text, mesh=_cpu(p), sort_method="sample")
    assert np.array_equal(got, oracle.suffix_array(text))


def test_suffix_array_rejects_unknown_method_and_takes_empty():
    with pytest.raises(ValueError, match="sort_method"):
        psd.suffix_array_sharded(np.zeros(64, np.int64), mesh=_cpu(8),
                                 sort_method="quantum")
    assert psd.suffix_array_sharded(np.zeros(0, np.int64),
                                    mesh=_cpu(2)).size == 0


# -- build_bwt_sharded ------------------------------------------------------------


@pytest.mark.parametrize("p", SIZES)
def test_build_bwt_matches_jax_and_oracle(jax_ref, p):
    got = psd.build_bwt_sharded(jax_ref["col"], mesh=_cpu(p))
    want = oracle.build_bwt(jax_ref["col"])
    assert np.array_equal(got.syms, want.syms)
    assert np.array_equal(got.lens, want.lens)
    assert np.array_equal(got.syms, jax_ref["bwt"].syms)
    assert np.array_equal(got.lens, jax_ref["bwt"].lens)


@pytest.mark.parametrize("p", SIZES)
def test_build_bwt_matches_single_device_build(rng, p):
    from bwtmerge_tpu_torch.ops.sa_torch import build_bwt_device

    col = oracle.random_collection(rng, 25, 5, 40)
    got = psd.build_bwt_sharded(col, mesh=_cpu(p), sort_method="sample")
    want = build_bwt_device(col, device="cpu")
    assert np.array_equal(got.syms, want.syms)
    assert np.array_equal(got.lens, want.lens)


def test_build_bwt_rejects_endmarkers_and_takes_empty():
    with pytest.raises(ValueError, match="endmarkers"):
        psd.build_bwt_sharded([np.array([1, 0, 2])], mesh=_cpu(2))
    assert psd.build_bwt_sharded([], mesh=_cpu(2)).n_runs == 0


# -- rlo_order_sharded ------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 7, 8, 40, 100])
@pytest.mark.parametrize("p", SIZES)
def test_rlo_order_matches_host(rng, p, m):
    seqs = [rng.integers(1, 6, rng.integers(1, 35)) for _ in range(m)]
    assert np.array_equal(psd.rlo_order_sharded(seqs, mesh=_cpu(p)),
                          rlo_order(seqs))


@pytest.mark.parametrize("p", SIZES)
def test_rlo_order_matches_jax(jax_ref, p):
    for method in ("oddeven", "sample"):
        got = psd.rlo_order_sharded(jax_ref["seqs"], mesh=_cpu(p),
                                    sort_method=method)
        assert np.array_equal(got, jax_ref["rlo"]), method


@pytest.mark.parametrize("p", SIZES)
def test_rlo_duplicate_reads_stay_stable(rng, p):
    base = [rng.integers(1, 6, 12) for _ in range(5)]
    seqs = [base[i % 5] for i in range(50)]
    assert np.array_equal(psd.rlo_order_sharded(seqs, mesh=_cpu(p)),
                          rlo_order(seqs))


@pytest.mark.parametrize("p", SIZES)
def test_sharded_rlo_build_matches_host(rng, p):
    from bwtmerge_tpu.models.build import build_from_reads as j_build
    from bwtmerge_tpu_torch.models.build import build_from_reads

    col = oracle.random_collection(rng, 30, 8, 50)
    got, got_order = build_from_reads(col, rlo=True, backend="sharded",
                                      device="cpu", mesh=_cpu(p))
    want, want_order = j_build(col, rlo=True, backend="numpy")
    assert np.array_equal(got_order, want_order)
    assert np.array_equal(got.syms, want.syms)
    assert np.array_equal(got.lens, want.lens)
