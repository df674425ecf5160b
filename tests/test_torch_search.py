"""The port's trie search (bwtmerge_tpu_torch/ops/search_torch.py) against
the JAX package's (bwtmerge_tpu/ops/search_jax.py) and the numpy search, on
the CPU.  Everything is an integer: the tolerance is zero.

The JAX streamed step runs its Pallas kernel in interpret mode (its inputs
here are tiny); the port's streamed steps run the probe's plain version, as
every wrapper does on a CPU tensor.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bwtmerge_tpu_torch as port  # noqa: E402
from bwtmerge_tpu.models import fmi as jax_fmi  # noqa: E402
from bwtmerge_tpu.models import merge as jax_merge  # noqa: E402
from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.ops import rank_jax, search_jax  # noqa: E402
from bwtmerge_tpu.ops import search_np as jax_search_np  # noqa: E402
from bwtmerge_tpu_torch.formats.sidecar import (sidecar_path,  # noqa: E402
                                                write_sidecar_reads)
from bwtmerge_tpu_torch.ops import search_torch  # noqa: E402
from bwtmerge_tpu_torch.utils.ranges import get_bounds  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()


def _reads(kind, seed):
    """Collections (A, B) of comp arrays for one named case."""
    r = np.random.default_rng(seed)
    a = oracle.random_collection(r, 9, 1, 30)
    if kind == "mixed":                 # reads of 1..40 characters
        b = oracle.random_collection(r, 11, 1, 40)
    elif kind == "duplicates":          # the range phase lasts to the end
        b = oracle.random_collection(r, 4, 6, 12)
        b = b + [b[0].copy(), b[0].copy(), b[2].copy()]
    elif kind == "single":              # B of one read: singles from depth 0
        b = oracle.random_collection(r, 1, 17, 17)
    elif kind == "shared":              # B's reads are A's: long shared paths
        b = [s.copy() for s in a[:5]]
    else:
        raise AssertionError(kind)
    return a, b


CASES = [("mixed", 1), ("mixed", 2), ("mixed", 3), ("duplicates", 4),
         ("single", 5), ("shared", 6)]


def _fmis(a, b, cls=port.FMI):
    return (cls.from_runs(oracle.build_bwt(a)),
            cls.from_runs(oracle.build_bwt(b)))


def _numpy_ra(fa, fb):
    return jax_search_np.build_rank_array(
        fa.rank_index, fa.alpha.C.astype(np.int64),
        fb.rank_index, fb.alpha.C.astype(np.int64),
        fa.sequences(), fb.sequences())


def _frontier_at(fa, fb, depth):
    """The port's frontier after `depth` gather steps from the root."""
    ai, bi = fa.device_index("cpu"), fb.device_index("cpu")
    node = (torch.tensor([fa.sequences()]), torch.tensor([0]),
            torch.tensor([fb.sequences() - 1]))
    for _ in range(depth):
        node = search_torch.expand_step(ai, bi, *node)
    return node


def _triples(a_pos, sp, ep):
    rows = np.stack([np.asarray(a_pos, np.int64), np.asarray(sp, np.int64),
                     np.asarray(ep, np.int64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _jax_indexes(fa, fb):
    return (rank_jax.DeviceFMIndex.build(fa.runs, fa.alpha.counts()),
            rank_jax.DeviceFMIndex.build(fb.runs, fb.alpha.counts()))


def _jax_frontier(node, cap):
    """A frontier padded to `cap` lanes with the JAX step's valid mask."""
    f = node[0].numel()
    pad = lambda t, fill: jnp.asarray(np.concatenate(  # noqa: E731
        [t.numpy().astype(np.int32), np.full(cap - f, fill, np.int32)]))
    valid = jnp.asarray(np.arange(cap) < f)
    return pad(node[0], 0), pad(node[1], 0), pad(node[2], -1), valid


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("kind,seed", [("mixed", 1), ("duplicates", 4)])
def test_expand_step_matches_jax(kind, seed, depth):
    fa, fb = _fmis(*_reads(kind, seed))
    node = _frontier_at(fa, fb, depth)
    assert node[0].numel() > 0
    ja, jb = _jax_indexes(fa, fb)
    out_a, out_sp, out_ep, count = search_jax._expand_step(
        ja, jb, *_jax_frontier(node, 128))
    n = int(count)
    got = search_torch.expand_step(fa.device_index("cpu"),
                                   fb.device_index("cpu"), *node)
    assert got[0].numel() == n
    assert all(t.dtype == torch.int64 for t in got)
    assert np.array_equal(
        _triples(*[t.numpy() for t in got]),
        _triples(np.asarray(out_a)[:n], np.asarray(out_sp)[:n],
                 np.asarray(out_ep)[:n]))


@pytest.mark.parametrize("depth", [0, 1, 3])
@pytest.mark.parametrize("kind,seed", [("mixed", 2), ("duplicates", 4)])
def test_expand_step_streamed_matches_jax(kind, seed, depth):
    fa, fb = _fmis(*_reads(kind, seed))
    node = _frontier_at(fa, fb, depth)
    ja, jb = _jax_indexes(fa, fb)
    out_a, out_sp, out_ep, count = search_jax._expand_step_streamed(
        ja, jb, search_jax._probe_planes(ja), search_jax._probe_planes(jb),
        *_jax_frontier(node, 64))       # the Pallas kernel, interpreted
    n = int(count)
    got = search_torch.expand_step_streamed(fa.device_index("cpu"),
                                            fb.device_index("cpu"), *node)
    assert got[0].numel() == n
    want = _triples(np.asarray(out_a)[:n], np.asarray(out_sp)[:n],
                    np.asarray(out_ep)[:n])
    assert np.array_equal(_triples(*[t.numpy() for t in got]), want)
    # and the gather step gives the same children
    plain = search_torch.expand_step(fa.device_index("cpu"),
                                     fb.device_index("cpu"), *node)
    assert np.array_equal(_triples(*[t.numpy() for t in plain]), want)


def test_expand_step_takes_ep_plus_one_equal_size():
    # the root of the last block ends at B's last endmarker; a node whose
    # range ends at B's last suffix probes q == size
    a, b = _reads("mixed", 3)
    fa, fb = _fmis(a, b)
    ai, bi = fa.device_index("cpu"), fb.device_index("cpu")
    node = (torch.tensor([0, 5]), torch.tensor([0, fb.size() - 3]),
            torch.tensor([2, fb.size() - 1]))
    s = search_torch.expand_step_streamed(ai, bi, *node)
    g = search_torch.expand_step(ai, bi, *node)
    assert np.array_equal(_triples(*[t.numpy() for t in s]),
                          _triples(*[t.numpy() for t in g]))
    # children partition each parent's range (less its endmarker rows)
    assert int((g[2] - g[1] + 1).sum()) <= 3 + 3


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("kind,seed", [("mixed", 1), ("duplicates", 4),
                                       ("single", 5)])
def test_singles_phase_keeps_spos_ascending(kind, seed, streamed):
    # the streamed singles step relies on, and must hand on, an ascending
    # spos; both singles steps agree as multisets at every depth
    fa, fb = _fmis(*_reads(kind, seed))
    ai, bi = fa.device_index("cpu"), fb.device_index("cpu")
    sa = torch.arange(fb.sequences(), dtype=torch.int64) % max(1, fa.size())
    spos = torch.arange(fb.sequences(), dtype=torch.int64)
    step = (search_torch.singles_step_streamed if streamed
            else search_torch.singles_step)
    ref_sa, ref_spos = sa, spos
    for _ in range(6):
        sa, spos = step(ai, bi, sa, spos)
        ref_sa, ref_spos = search_torch.singles_step(ai, bi, ref_sa, ref_spos)
        if streamed:
            assert bool((spos[1:] >= spos[:-1]).all())
        got = np.stack([sa.numpy(), spos.numpy()], 1)
        want = np.stack([ref_sa.numpy(), ref_spos.numpy()], 1)
        assert np.array_equal(got[np.lexsort(got.T[::-1])],
                              want[np.lexsort(want.T[::-1])])


@pytest.mark.parametrize("kind,seed", [("mixed", 1), ("single", 5),
                                       ("shared", 6)])
def test_singles_step_streamed_matches_jax(kind, seed):
    """The streamed singles step (K1's lf form on B, its select form on A)
    against the JAX index's LF step and ranks, over a depth of singletons
    at every B position (a_pos any A position, spos ascending)."""
    fa, fb = _fmis(*_reads(kind, seed))
    ja, jb = _jax_indexes(fa, fb)
    rng = np.random.default_rng(seed)
    spos = np.arange(fb.size(), dtype=np.int64)
    sa = rng.integers(0, fa.size() + 1, size=spos.size)
    lf, c = (np.asarray(x, np.int64) for x in jb.LF_step(jnp.asarray(spos)))
    child = (np.asarray(ja.C, np.int64)[c]
             + np.asarray(ja.rank(jnp.asarray(sa), jnp.asarray(c))))
    alive = c != 0
    want = np.stack([child[alive], lf[alive]], 1)
    got_sa, got_spos = search_torch.singles_step_streamed(
        fa.device_index("cpu"), fb.device_index("cpu"), torch.from_numpy(sa),
        torch.from_numpy(spos))
    assert bool((got_spos[1:] >= got_spos[:-1]).all())
    got = np.stack([got_sa.numpy(), got_spos.numpy()], 1)
    assert np.array_equal(got[np.lexsort(got.T[::-1])],
                          want[np.lexsort(want.T[::-1])])


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind,seed", CASES)
def test_full_search_matches_numpy_and_jax(kind, seed, blocks, streamed):
    a, b = _reads(kind, seed)
    fa, fb = _fmis(a, b)
    want = _numpy_ra(fa, fb)
    config = port.MergeConfig(device="cpu")
    got = search_torch.build_rank_array_torch(fa, fb, config,
                                              sequence_blocks=blocks,
                                              streamed=streamed)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert int(got[1].sum()) == fb.size()
    # the port's own numpy search is the same function
    from bwtmerge_tpu_torch.ops import search_np

    own = search_np.build_rank_array(
        fa.rank_index, fa.alpha.C.astype(np.int64),
        fb.rank_index, fb.alpha.C.astype(np.int64),
        fa.sequences(), fb.sequences())
    assert np.array_equal(own[0], want[0]) and np.array_equal(own[1], want[1])
    if not streamed:
        ja, jb = _fmis(a, b, jax_fmi.FMI)
        jv, jc = search_jax.build_rank_array_jax(
            ja, jb, jax_merge.MergeConfig(backend="jax",
                                          sequence_blocks=blocks))
        jv, jc = jax_search_np.compact_rank_array(jv, jc)
        assert np.array_equal(got[0], jv) and np.array_equal(got[1], jc)


def test_raw_emissions_match_jax_device_search():
    # wavefront_search's unsorted emissions against the JAX package's
    # two-phase device search, both reduced by compact_rank_array
    a, b = _reads("mixed", 2)
    fa, fb = _fmis(a, b)
    ja, jb = _jax_indexes(fa, fb)
    v, c, n, ovf = search_jax.wavefront_search_device2(
        ja, jb, jnp.int32(0), jnp.int32(fb.sequences() - 1), fa.sequences(),
        frontier_cap=512, emit_cap=4096)
    assert not bool(ovf)
    n = int(n)
    want = jax_search_np.compact_rank_array(np.asarray(v[:n], np.int64),
                                            np.asarray(c[:n], np.int64))
    for streamed in (False, True):
        values, counts = search_torch.wavefront_search(
            fa.device_index("cpu"), fb.device_index("cpu"),
            (0, fb.sequences() - 1), fa.sequences(), streamed=streamed)
        assert values.numel() == n
        got = jax_search_np.compact_rank_array(values.numpy(), counts.numpy())
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        uv, uc = search_torch.compact_pairs(values, counts)
        assert np.array_equal(uv.numpy(), want[0])
        assert np.array_equal(uc.numpy(), want[1])


@pytest.mark.parametrize("streamed", [False, True])
def test_empty_block_and_more_blocks_than_reads(streamed):
    a, b = _reads("mixed", 1)
    fa, fb = _fmis(a, b)
    ai, bi = fa.device_index("cpu"), fb.device_index("cpu")
    v, c = search_torch.wavefront_search(ai, bi, (3, 2), fa.sequences(),
                                         streamed=streamed)
    assert v.numel() == 0 and c.numel() == 0
    # one block per read and then some: get_bounds hands out empty blocks
    n_blocks = fb.sequences() + 3
    assert len(get_bounds((0, fb.sequences() - 1), n_blocks)) >= 1
    got = search_torch.build_rank_array_torch(
        fa, fb, port.MergeConfig(device="cpu"), sequence_blocks=n_blocks,
        streamed=streamed)
    want = _numpy_ra(fa, fb)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_default_streamed_follows_the_device():
    assert search_torch.default_streamed("cpu") is False
    assert search_torch.default_streamed(torch.device("cuda", 0)) is True


def test_search_refuses_indexes_on_different_devices():
    fa, fb = _fmis(*_reads("single", 5))
    ai = fa.device_index("cpu")
    bi = fb.device_index("cpu")
    moved = type(bi)(rec=bi.rec.to("meta"), C=bi.C.to("meta"), size=bi.size,
                     n_runs=bi.n_runs)
    with pytest.raises(ValueError, match="different devices"):
        search_torch.wavefront_search(ai, moved, (0, 0), fa.sequences())


# -- the merge on the trie search ---------------------------------------------


def _write(tmp_path, name, seqs, sidecar):
    path = str(tmp_path / f"{name}.sga")
    port.serialize_fmi(port.FMI.from_runs(oracle.build_bwt(seqs)), path,
                       "sga")
    if sidecar:
        write_sidecar_reads(sidecar_path(path), seqs)
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("blocks", [0, 2])
@pytest.mark.parametrize("kind,seed", CASES)
def test_merge_fmi_trie_matches_jax_and_oracle(tmp_path, kind, seed, blocks):
    a, b = _reads(kind, seed)
    a_path = _write(tmp_path, "a", a, False)
    b_path = _write(tmp_path, "b", b, True)
    want = str(tmp_path / "jax.sga")
    merged = jax_merge.merge_fmi(
        jax_fmi.load_fmi(a_path, "sga"), jax_fmi.load_fmi(b_path, "sga"),
        jax_merge.MergeConfig(backend="jax", search="trie",
                              temp_dir=str(tmp_path)))
    jax_fmi.serialize_fmi(merged, want, "sga")
    got = str(tmp_path / "port.sga")
    m = port.merge_fmi(port.load_fmi(a_path, "sga"),
                       port.load_fmi(b_path, "sga"),
                       port.MergeConfig(device="cpu", search="trie",
                                        device_blocks=blocks))
    port.serialize_fmi(m, got, "sga")
    assert _read(got) == _read(want)
    assert m.runs == oracle.merge_collections([a, b])
    assert m.hash() == merged.hash()


@pytest.mark.parametrize("route", ["fmi", "to_file", "files"])
@pytest.mark.parametrize("seed", [1, 2])
def test_trie_and_walk_give_the_same_file(tmp_path, seed, route):
    a, b = _reads("mixed", seed)
    a_path = _write(tmp_path, "a", a, False)
    b_path = _write(tmp_path, "b", b, True)
    outs = {}
    for search in ("walk", "trie", "auto"):
        out = str(tmp_path / f"{search}.sga")
        config = port.MergeConfig(device="cpu", search=search,
                                  temp_dir=str(tmp_path))
        if route == "files":
            port.merge_files(a_path, b_path, out, "sga", "sga", config)
        else:
            fa, fb = port.load_fmi(a_path, "sga"), port.load_fmi(b_path, "sga")
            if route == "fmi":
                port.serialize_fmi(port.merge_fmi(fa, fb, config), out, "sga")
            else:
                port.merge_fmi_to_file(fa, fb, out, "sga", config)
        outs[search] = _read(out)
    assert outs["walk"] == outs["trie"] == outs["auto"]


def test_trie_never_reads_the_sidecar(tmp_path, monkeypatch):
    a, b = _reads("mixed", 3)
    a_path = _write(tmp_path, "a", a, False)
    b_path = _write(tmp_path, "b", b, True)
    fb = port.load_fmi(b_path, "sga")

    def boom():
        raise AssertionError("search='trie' looked at the sidecar")

    monkeypatch.setattr(fb, "creads", boom)
    m = port.merge_fmi(port.load_fmi(a_path, "sga"), fb,
                       port.MergeConfig(device="cpu", search="trie"))
    assert m.runs == oracle.merge_collections([a, b])


@pytest.mark.parametrize("search", ["auto", "walk", "trie"])
def test_b_with_no_reads_merges_to_a(tmp_path, search):
    a, _ = _reads("mixed", 1)
    fa = port.FMI.from_runs(oracle.build_bwt(a))
    fb = port.FMI.from_runs(oracle.build_bwt([]))
    assert fb.sequences() == 0 and fb.size() == 0
    m = port.merge_fmi(fa, fb, port.MergeConfig(device="cpu", search=search))
    assert m.runs == fa.runs
    ja, jb = _fmis(a, [], jax_fmi.FMI)
    jm = jax_merge.merge_fmi(ja, jb, jax_merge.MergeConfig(backend="jax"))
    assert m.runs == jm.runs


def test_walk_falls_to_the_trie_for_a_long_read(tmp_path, monkeypatch):
    # under search='walk' a read at the walk's cap sends the merge to the
    # trie search (the cap is lowered so a read of 90 reaches it)
    from bwtmerge_tpu_torch.models import merge as port_merge

    monkeypatch.setattr(port_merge, "WALK_MAX_LEN", 64)
    r = np.random.default_rng(8)
    a = oracle.random_collection(r, 6, 1, 30)
    b = oracle.random_collection(r, 5, 1, 30)
    b.append(r.integers(1, 5, size=90).astype(np.uint8))
    fa, fb = _fmis(a, b)
    called = []
    real = search_torch.blocked_search
    monkeypatch.setattr(search_torch, "blocked_search",
                        lambda *args, **kw: called.append(1) or real(*args,
                                                                      **kw))
    m = port.merge_fmi(fa, fb, port.MergeConfig(device="cpu", search="walk"))
    assert called == [1]
    assert m.runs == oracle.merge_collections([a, b])
