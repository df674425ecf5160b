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
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()

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


PROBE_FORMS = ["full", "select", "lf"]


def _sorted_keys(n, rng, live=200, sent=40):
    """A sorted batch of `live` positions in [0, n], the last one n, then
    `sent` 2^31-1 sentinels."""
    q = np.sort(rng.integers(0, n + 1, size=live)).astype(np.int32)
    q[-1] = n                                              # q == size
    return np.concatenate([q, np.full(sent, SENT, np.int32)])


def _pallas(j, q):
    """The Pallas probe, interpreted: int32[16, Q]."""
    return np.asarray(rank_pallas.streamed_probe(j.rec, jnp.asarray(q),
                                                 interpret=True))


def _row_select(p, c):
    """rank_pallas._row_select of p's rank rows at characters c, clamped to
    [0, 7] as backward_search_streamed clamps them."""
    c = np.clip(np.asarray(c, np.int64), 0, rank_torch.LANES - 1)
    return np.asarray(rank_pallas._row_select(
        jnp.asarray(p[:rank_torch.LANES]), jnp.asarray(c.astype(np.int32))))


def _form(form, rec, q, chars, n, perm=None):
    """K1's `form` of the port on CPU tensors, as numpy."""
    if form == "full":
        got = rank_streamed.streamed_probe(rec, q, n)
    elif form == "lf":
        got = rank_streamed.streamed_lf(rec, q, n)
    else:
        got = rank_streamed.streamed_select(rec, q, chars, n, perm)
    return got.numpy()


def _pallas_form(form, p, chars):
    """What `form` answers, from the Pallas probe's rows p."""
    if form == "full":
        return p[:rank_torch.LANES + 1]
    if form == "lf":
        return np.stack([p[rank_torch.LANES],
                         _row_select(p, p[rank_torch.LANES])])
    return _row_select(p, chars)


@pytest.mark.parametrize("form", PROBE_FORMS)
@pytest.mark.parametrize("seed", [0, 1, "mult32", "tiny"])
def test_plain_probe_matches_pallas(seed, form):
    """Each of K1's forms equals what its callers took from the Pallas
    probe's 16 rows, whose rows 9-15 are zero: the full form its rows 0-8,
    the select form the rank of a character beside each key (0, 7, 8 and
    255 among them, clamped to [0, 7]), the lf form row 8 and the rank of
    that symbol.  Every form writes zeros at the sentinels."""
    j, t, runs = _pair(seed)
    n = runs.size()
    rng = np.random.default_rng(12)
    q = _sorted_keys(n, rng)
    chars = rng.integers(0, 9, size=q.size).astype(np.int32)
    chars[:4] = (0, 7, 8, 255)
    want = _pallas(j, q)
    assert not want[rank_torch.LANES + 1:, :200].any()     # the TPU's pad
    got = _form(form, t.rec, torch.from_numpy(q), torch.from_numpy(chars), n)
    assert got.shape == {"full": (9, 240), "lf": (2, 240),
                         "select": (240,)}[form]
    np.testing.assert_array_equal(got[..., :200],
                                  _pallas_form(form, want, chars)[..., :200])
    assert not got[..., 200:].any()
    if form != "select":
        assert got[-1 if form == "full" else 0, 199] == rank_torch.SIGMA


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.int32,
                                   np.int64])
def test_select_form_takes_each_char_dtype_and_the_sort_permutation(
        pair, dtype, fused):
    """The select form reads its characters in the caller's dtype, clamped
    to [0, 7] (negative int8 to 0); given the sort's permutation it reads
    them in the caller's order and writes each rank back there, as the
    Pallas search's sort, probe, select and realign do."""
    j, t, runs = pair
    n = runs.size()
    rng = np.random.default_rng(15)
    q_lane = rng.permutation(_sorted_keys(n, rng, live=300, sent=60))
    info = np.iinfo(dtype)
    chars = rng.integers(max(info.min, -3), 9, size=q_lane.size)
    chars[:4] = (0, 7, 8, info.max)
    chars = chars.astype(dtype)
    ks, perm = torch.sort(torch.from_numpy(q_lane))
    p = _pallas(j, ks.numpy())
    order = perm.numpy()
    if fused:
        got = _form("select", t.rec, ks, torch.from_numpy(chars), n, perm)
        want = np.empty(q_lane.size, np.int32)
        want[order] = _row_select(p, chars[order])
        live = q_lane != SENT
    else:
        got = _form("select", t.rec, ks, torch.from_numpy(chars[order]), n)
        want = _row_select(p, chars[order])
        live = ks.numpy() != SENT
    np.testing.assert_array_equal(got[live], want[live])
    assert not got[~live].any()


def test_lf_form_is_the_gather_paths_lf_step(pair):
    _, t, runs = pair
    n = runs.size()
    q = torch.arange(n, dtype=torch.int32)
    sym, rk = rank_streamed.streamed_lf(t.rec, q, n)
    want_rk, want_sym = t.inverse_select(q)
    assert torch.equal(sym, want_sym) and torch.equal(rk, want_rk)


@pytest.mark.parametrize("form", PROBE_FORMS)
def test_probe_empty_and_all_sentinel_batches(pair, form):
    _, t, runs = pair
    shape = {"full": (9,), "lf": (2,), "select": ()}[form]
    for n_q, key in ((0, 0), (64, SENT)):
        q = torch.full((n_q,), key, dtype=torch.int32)
        got = _form(form, t.rec, q, torch.full((n_q,), 3, dtype=torch.int32),
                    runs.size())
        assert got.shape == shape + (n_q,) and not got.any()


@pytest.mark.parametrize("form", PROBE_FORMS)
def test_probe_wrapper_rejects_bad_inputs(pair, form):
    _, t, runs = pair
    q = torch.zeros(4, dtype=torch.int32)
    c = torch.zeros(4, dtype=torch.int32)
    n = runs.size()
    with pytest.raises(ValueError):
        _form(form, t.rec.to(torch.int64), q, c, n)
    with pytest.raises(ValueError):
        _form(form, t.rec, q.to(torch.int64), c, n)
    with pytest.raises(ValueError):
        _form(form, t.rec, q, c, 32 * t.rec.shape[0])
    if form == "select":
        for chars, perm in ((c[:3], None), (c.to(torch.float32), None),
                            (c, torch.arange(4, dtype=torch.int32)),
                            (c, torch.arange(3))):
            with pytest.raises(ValueError):
                rank_streamed.streamed_select(t.rec, q, chars, n, perm)


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


def _swapped_t_n():
    """char2comp of the SORTED order ($ACGNT): T and N swap comps."""
    c2c = Alphabet().char2comp.copy()
    for ch, comp in (("T", 5), ("N", 4)):
        c2c[ord(ch)] = c2c[ord(ch.lower())] = comp
    return c2c


@pytest.mark.parametrize("n, alphabets", [
    pytest.param(50, 1, id="50"), pytest.param(1 << 14, 1, id="16384"),
    pytest.param(50, 2, id="50-two_alphabets"),
    pytest.param(1 << 14, 2, id="16384-two_alphabets")])
def test_batch_count_matches_jax(n, alphabets, monkeypatch):
    seqs = _collection(6)
    runs = oracle.build_bwt(seqs)
    j = rank_jax.DeviceFMIndex.build(runs, runs.counts(6))
    t = rank_torch.DeviceFMIndex.build(runs, runs.counts(6), "cpu")
    pats = _patterns(seqs, np.random.default_rng(15), n)
    c2c = Alphabet().char2comp
    want = rank_jax.batch_count(j, pats, c2c)
    if alphabets == 2:
        # one PatternBatch counted through two indexes of two alphabets:
        # its byte matrix is built once, each count maps it its own way
        built = []
        plain = rank_torch.pattern_bytes
        monkeypatch.setattr(rank_torch, "pattern_bytes",
                            lambda p: built.append(1) or plain(p))
        batch = rank_torch.PatternBatch(pats)
        got = rank_torch.batch_count(t, batch, c2c)
        seqs2 = _collection(7)
        runs2 = oracle.build_bwt(seqs2)
        c2c2 = _swapped_t_n()
        j2 = rank_jax.DeviceFMIndex.build(runs2, runs2.counts(6))
        t2 = rank_torch.DeviceFMIndex.build(runs2, runs2.counts(6), "cpu")
        np.testing.assert_array_equal(
            rank_torch.batch_count(t2, batch, c2c2),
            rank_jax.batch_count(j2, pats, c2c2))
        assert len(built) == 1
    else:
        got = rank_torch.batch_count(t, pats, c2c)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.sum() > 0
    # the bytes/array forms encode to the same comps as the str fast path
    mixed = [p.encode() if k % 2 else c2c[np.frombuffer(p.encode(), np.uint8)]
             for k, p in enumerate(pats[:40])]
    np.testing.assert_array_equal(rank_torch.batch_count(t, mixed, c2c),
                                  want[:40])


def _loop_encode(patterns, char2comp):
    """The per-pattern encoding of rank_jax.batch_count: str encoded, bytes
    through char2comp, arrays as they are, zero-padded rows."""
    comps = []
    for p in patterns:
        if isinstance(p, str):
            p = p.encode()
        if isinstance(p, (bytes, bytearray)):
            arr = char2comp[np.frombuffer(bytes(p), dtype=np.uint8)]
        else:
            arr = np.asarray(p)
        comps.append(arr.astype(np.int32))
    out = np.zeros((len(comps), max(c.size for c in comps)), np.int32)
    for k, c in enumerate(comps):
        out[k, : c.size] = c
    return out, np.array([c.size for c in comps], np.int32)


def _pattern_case(case, tmp_path):
    rng = np.random.default_rng(31)
    dna = np.array(list("ACGT"))
    if case == "uniform":
        return ["".join(rng.choice(dna, 32)) for _ in range(300)]
    if case == "ragged":
        return ["".join(rng.choice(np.array(list("ACGTNacgt$x")),
                                   int(rng.integers(0, 40))))
                for _ in range(300)]
    if case == "crlf":
        from bwtmerge_tpu_torch.cli.common import read_rows

        path = tmp_path / "crlf.txt"
        path.write_bytes(b"ACGT\r\nGATTACA\r\n\r\nTTN\r\nacg")
        return read_rows(str(path))
    if case == "one_long":
        return ["ACG"] * 20 + ["".join(rng.choice(dna, 5000))] + ["T"] * 20
    if case == "bytes_and_arrays":
        return [b"ACGT", np.array([1, 2, 3]), "GA", bytearray(b"\x00Tn"),
                np.zeros(0, np.int64), np.array([5, 0, 4, 4])]
    return ["ACéGT", "TTT", "中A", "", "N\u00ff"]     # non-ASCII str


@pytest.mark.parametrize("case", ["uniform", "ragged", "crlf", "one_long",
                                  "bytes_and_arrays", "non_ascii"])
def test_pattern_batch_encodes_as_the_loop(case, tmp_path):
    """The byte matrix mapped through char2comp (as batch_count maps it on
    the index's device, here CPU tensors), and encode_patterns, equal the
    per-pattern loop's comps and lengths, for both alphabets."""
    pats = _pattern_case(case, tmp_path)
    batch = rank_torch.PatternBatch(pats)
    raw, lens, given = batch.on("cpu")
    assert raw.dtype == torch.uint8 and lens.dtype == torch.int32
    assert (given is not None) == (case == "bytes_and_arrays")
    for c2c in (Alphabet().char2comp, _swapped_t_n()):
        want_c, want_l = _loop_encode(pats, c2c)
        table = torch.from_numpy(c2c.astype(np.int32))
        np.testing.assert_array_equal(
            rank_torch.map_comps(raw, lens, given, table).numpy(), want_c)
        np.testing.assert_array_equal(lens.numpy(), want_l)
        comps, got_l = rank_torch.encode_patterns(pats, c2c)
        np.testing.assert_array_equal(comps, want_c)
        np.testing.assert_array_equal(got_l, want_l)
        assert comps.dtype == np.int32 and got_l.dtype == np.int32


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


# -- the record build (B3): plain version, slabs and the wrapper ------------


def _nibbles(nblk, seed, pad_from=None):
    """Seeded block-planar nibbles of nblk blocks: symbols 0..5, SIGMA from
    position pad_from on (the tail block's pad)."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, rank_torch.SIGMA, size=nblk * 32).astype(np.uint8)
    if pad_from is not None:
        syms[pad_from:] = rank_torch.SIGMA
    blk = syms.reshape(nblk, 32)
    return (blk[:, :16] | (blk[:, 16:] << 4)).reshape(-1)


@pytest.mark.parametrize("nblk,pad_from", [(1, 0), (1, 17), (2, 40),
                                           (255, None), (257, 8000),
                                           (1000, 31_999)])
def test_build_rec_plain_matches_jax(nblk, pad_from):
    nib = _nibbles(nblk, nblk, pad_from)
    want = np.asarray(rank_jax._build_rec_device(jnp.asarray(nib)))
    got = rank_torch.build_rec_plain(torch.from_numpy(nib), nblk)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        rank_torch.build_rec(torch.from_numpy(nib), nblk).numpy(), want)


@pytest.mark.parametrize("start_blk,slab_blk", [(0, 4), (3, 8), (100, 64)])
def test_build_rec_plain_with_a_base_matches_jax_slab(start_blk, slab_blk):
    nib = _nibbles(start_blk + slab_blk + 5, 7, pad_from=None)
    base = np.random.default_rng(start_blk).integers(
        0, 1 << 20, size=rank_torch.LANES).astype(np.int32)
    want, counts = rank_jax._build_rec_slab(
        jnp.asarray(nib), jnp.int32(start_blk * 16), slab_blk * 16,
        jnp.asarray(base))
    part = torch.from_numpy(nib[start_blk * 16:(start_blk + slab_blk) * 16])
    for fn in (rank_torch.build_rec_plain, rank_torch.build_rec):
        got = fn(part, slab_blk, torch.from_numpy(base))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the slab's totals: its last row plus its last block's counts
    last = rank_torch.unpack_symbols(got[-1:, 8:])[0]
    total = got[-1, :8].numpy() - base + np.bincount(
        last.numpy(), minlength=rank_torch.LANES)
    np.testing.assert_array_equal(total, np.asarray(counts))


@pytest.mark.parametrize("slab_blk,n_slabs,short", [(4, 3, 0), (8, 5, 3),
                                                    (64, 4, 1)])
def test_slab_by_slab_build_matches_build_rec_slabbed(monkeypatch, slab_blk,
                                                      n_slabs, short):
    # the JAX slab loop engages from three slabs up; the port builds each
    # slab with its running base and concatenates
    monkeypatch.setattr(rank_jax, "REC_SLAB_BLK", slab_blk)
    total_blk = slab_blk * n_slabs
    nib = _nibbles(total_blk, slab_blk, pad_from=total_blk * 32 - 50)
    nblk = total_blk - short
    want = np.asarray(rank_jax.build_rec_slabbed(jnp.asarray(nib), nblk))
    assert want.shape == (nblk, 16)
    parts, base = [], torch.zeros(rank_torch.LANES, dtype=torch.int64)
    for s in range(n_slabs):
        part = torch.from_numpy(nib[s * slab_blk * 16:(s + 1) * slab_blk * 16])
        parts.append(rank_torch.build_rec(part, slab_blk, base))
        base += torch.bincount(torch.cat([part & 0xF, part >> 4]).long(),
                               minlength=16)[:rank_torch.LANES]
    got = torch.cat(parts)[:nblk]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rank_torch.build_rec(torch.from_numpy(nib), nblk).numpy(), want)


def test_index_builds_go_through_the_wrapper(monkeypatch):
    # every index build reaches the record table through build_rec (which
    # launches rec_build on a card), never through the plain version
    from bwtmerge_tpu_torch.ops import rank_sharded

    calls = []
    wrapper = rank_torch.build_rec

    def counting(nibbles, nblk, base=None):
        calls.append((nblk, base is not None))
        return wrapper(nibbles, nblk, base)

    monkeypatch.setattr(rank_torch, "build_rec", counting)
    monkeypatch.setattr(rank_sharded, "build_rec", counting)
    runs = oracle.build_bwt(_collection(2))
    want = np.asarray(rank_jax.DeviceFMIndex.build(runs, runs.counts(6)).rec)
    nblk = runs.size() // 32 + 1
    built = rank_torch.DeviceFMIndex.build(runs, runs.counts(6), "cpu")
    assert calls == [(nblk, False)]
    np.testing.assert_array_equal(built.rec.numpy(), want[:nblk])
    nib, counts, size, n_runs = rank_torch.pack_nibbles_chunked(
        runs.iter_chunks(1 << 10))
    packed = rank_torch.DeviceFMIndex.from_nibbles(nib, counts, size, n_runs,
                                                   "cpu")
    assert calls[1:] == [(nblk, False)]
    np.testing.assert_array_equal(packed.rec.numpy(), want[:nblk])
    sharded = rank_sharded.ShardedFMIndex.build(runs, runs.counts(6),
                                                mesh=["cpu"] * 3)
    assert calls[2:] == [(sharded.slab, True)] * 3
    np.testing.assert_array_equal(
        torch.cat(sharded.slabs)[:nblk].numpy(), want[:nblk])


def test_rec_build_entry_rejects_bad_inputs():
    nib = torch.from_numpy(_nibbles(4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        rank_torch.rec_build(nib, 4)                  # a CPU tensor
    for bad in (nib.to(torch.int8), nib.view(4, 16)):
        with pytest.raises(ValueError, match="uint8"):
            rank_torch.build_rec(bad, 4)
    with pytest.raises(ValueError, match="bytes"):
        rank_torch.build_rec(nib, 5)                  # a short buffer
    with pytest.raises(ValueError, match="bytes"):
        rank_torch.build_rec(nib, 0)
    with pytest.raises(ValueError, match="base"):
        rank_torch.build_rec(nib, 4, torch.zeros(6, dtype=torch.int32))


COUNT_QS = [1, 1 << 13, (1 << 13) + 1, 1 << 14, (1 << 16) - 1, 1 << 16,
            (1 << 16) + 1, 3 * (1 << 16) + 5]
LONG_ROW = 29


def _count_patterns(text, long_row, q, seed):
    """q patterns over `text` (a str): ragged substrings of 0..13
    characters, a seventh of them random (N included), every 13th empty,
    and row q // 2 `long_row`."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 14, q)
    starts = rng.integers(0, len(text) - 14, q)
    noise = "".join(rng.choice(np.array(list("ACGTN")), 16 * q))
    pats = [noise[16 * k:16 * k + n] if k % 7 == 3 else text[s:s + n]
            for k, (s, n) in enumerate(zip(starts.tolist(), lens.tolist()))]
    for k in range(0, q, 13):
        pats[k] = ""
    pats[q // 2] = long_row
    return pats


@pytest.fixture(scope="module")
def count_index():
    """The index of one collection on both packages, and per batch size
    its patterns with rank_jax.batch_count's counts (computed once)."""
    seqs = _collection(6)
    runs = oracle.build_bwt(seqs)
    j = rank_jax.DeviceFMIndex.build(runs, runs.counts(6))
    t = rank_torch.DeviceFMIndex.build(runs, runs.counts(6), "cpu")
    c2c = Alphabet().char2comp
    reads = [bytes(Alphabet().comp2char[s]).decode() for s in seqs]
    long_row = max(reads, key=len)[:LONG_ROW]     # found in one read
    assert len(long_row) == LONG_ROW
    cache = {}

    def case(q):
        if q not in cache:
            pats = _count_patterns("".join(reads), long_row, q, q)
            cache[q] = pats, rank_jax.batch_count(j, pats, c2c)
        return cache[q]

    return t, c2c, case


def _spy_searches(monkeypatch):
    """Record (search, rows) of every search _count_rows makes."""
    calls = []
    for mod, name in ((rank_torch, "backward_search"),
                      (rank_streamed, "backward_search_streamed")):
        plain = getattr(mod, name)

        def spy(index, pat, lens, max_len, plain=plain, name=name):
            calls.append((name, pat.shape[0]))
            return plain(index, pat, lens, max_len)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("chunks", ["one", "many"])
@pytest.mark.parametrize("q", COUNT_QS)
def test_counts_equal_jax_at_every_batch_size(count_index, q, chunks,
                                              monkeypatch):
    """batch_count and count_encoded equal rank_jax.batch_count (chunks of
    2^16 padded to a power of two) whether the batch is searched whole or
    in chunks of about a fifth of it; the streamed search takes batches of
    more than 2^13 patterns, as in the JAX package."""
    t, c2c, case = count_index
    pats, want = case(q)
    assert max(map(len, pats)) == LONG_ROW
    assert min(map(len, pats)) == 0 or q == 1
    per_row = rank_torch.COUNT_ROW_BYTES \
        + rank_torch.COUNT_CHAR_BYTES * LONG_ROW
    rows = q if chunks == "one" else max(1, q // 5)
    budget = rank_torch.COUNT_BUDGET if chunks == "one" else rows * per_row
    assert rank_torch.count_chunk_rows(LONG_ROW, budget) >= rows
    assert rank_torch.count_chunk_rows(LONG_ROW, budget) == rows \
        or chunks == "one"
    calls = _spy_searches(monkeypatch)
    comps, lens = rank_torch.encode_patterns(pats, c2c)
    for got in (rank_torch.batch_count(t, pats, c2c, budget),
                rank_torch.count_encoded(t, comps, lens, budget)):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    name = "backward_search_streamed" if q > 1 << 13 else "backward_search"
    sizes = [rows] * (q // rows) + ([q % rows] if q % rows else [])
    assert calls == [(name, n) for n in sizes] * 2
    assert want.sum() > 0


@pytest.mark.parametrize("q, rows", [(40, 1), (40, 7), ((1 << 14) + 3, 1000),
                                     ((1 << 14) + 3, (1 << 13) + 1)])
def test_small_budget_counts_equal_one_chunk(count_index, q, rows):
    """A budget that holds only `rows` patterns cuts the batch into chunks
    of that many (the last one short), and the counts equal one chunk's."""
    t, c2c, case = count_index
    pats, _ = case(q)
    one = rank_torch.batch_count(t, pats, c2c)
    per_row = rank_torch.COUNT_ROW_BYTES \
        + rank_torch.COUNT_CHAR_BYTES * LONG_ROW
    budget = rows * per_row + per_row - 1
    assert rank_torch.count_chunk_rows(LONG_ROW, budget) == rows
    many = rank_torch.batch_count(t, rank_torch.PatternBatch(pats), c2c,
                                  budget)
    np.testing.assert_array_equal(many, one)
    comps, lens = rank_torch.encode_patterns(pats, c2c)
    np.testing.assert_array_equal(
        rank_torch.count_encoded(t, comps, lens, budget), one)
    assert rank_torch.count_chunk_rows(LONG_ROW, 1) == 1
