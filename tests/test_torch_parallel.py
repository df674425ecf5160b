"""The port's multi-device paths (bwtmerge_tpu_torch/parallel/mesh.py,
ops/rank_sharded.py, the mesh routes of models/merge.py) and their two
repairs (the rank array's spill, the launch counts under threads) against
the JAX package on the CPU.

Each JAX function runs once, on its 8 virtual CPU devices
(tests/conftest.py), in a module-scoped fixture; the port's counterpart
runs at mesh sizes 1, 2, 4 and 8 of CPU entries on the same inputs, made
from a seed, and must give the same rank-array runs, counts and files.
Every quantity is an integer: the tolerance is zero.
"""

import os
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bwtmerge_tpu.formats.sidecar import creads_layout  # noqa: E402
from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.models.fmi import FMI as JFMI  # noqa: E402
from bwtmerge_tpu.ops import search_np  # noqa: E402
from bwtmerge_tpu.ops.rank_jax import DeviceFMIndex as JIndex  # noqa: E402
from bwtmerge_tpu.parallel import mesh as jmesh  # noqa: E402
import bwtmerge_tpu_torch as port  # noqa: E402
from bwtmerge_tpu_torch import kernels  # noqa: E402
from bwtmerge_tpu_torch.models.fmi import FMI  # noqa: E402
from bwtmerge_tpu_torch.ops import rank_sharded  # noqa: E402
from bwtmerge_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SIZES = [1, 2, 4, 8]


def _cpu(k):
    return ["cpu"] * k


def _same(got, want):
    return all(np.array_equal(np.asarray(g), np.asarray(w))
               for g, w in zip(got, want))


@pytest.fixture(scope="module")
def pair():
    """A and B (8 and 12 reads of 10-60), the JAX package's FMIs and device
    indexes, the port's, B's reads in walk layout, and the rank array by
    the JAX package's host search."""
    r = np.random.default_rng(0xB3714)
    a_seqs = oracle.random_collection(r, 8, 10, 60)
    b_seqs = oracle.random_collection(r, 12, 10, 60)
    ja = JFMI.from_runs(oracle.build_bwt(a_seqs))
    jb = JFMI.from_runs(oracle.build_bwt(b_seqs))
    pa = FMI.from_runs(ja.runs)
    pb = FMI.from_runs(jb.runs)
    want = search_np.build_rank_array(
        ja.rank_index, ja.alpha.C.astype(np.int64),
        jb.rank_index, jb.alpha.C.astype(np.int64),
        ja.sequences(), jb.sequences())
    creads = creads_layout(np.array([s.size for s in b_seqs], np.uint32),
                           np.concatenate(b_seqs).astype(np.uint8))
    return dict(a_seqs=a_seqs, b_seqs=b_seqs, ja=ja, jb=jb,
                ja_idx=JIndex.build(ja.runs, ja.alpha.counts()),
                jb_idx=JIndex.build(jb.runs, jb.alpha.counts()),
                pa=pa, pb=pb, pa_idx=pa.device_index("cpu"),
                pb_idx=pb.device_index("cpu"), want=want, creads=creads,
                n_a=ja.sequences(), n_b=jb.sequences())


@pytest.fixture(scope="module")
def jax_ra(pair):
    """The JAX package's sharded_rank_array and sharded_packed_ra on its 8
    devices (gather steps; the results do not depend on the mesh)."""
    p = pair
    v, c, ovf = jmesh.sharded_rank_array(
        p["ja_idx"], p["jb_idx"], p["n_a"], p["n_b"],
        mesh=jmesh.make_mesh(8), frontier_cap=2048, emit_cap=32768,
        streamed=False)
    packed = jmesh.sharded_packed_ra(
        p["ja_idx"], p["jb_idx"], p["n_a"], p["n_b"],
        mesh=jmesh.make_mesh(8), frontier_cap=2048, emit_cap=32768,
        streamed=False)
    assert not ovf and _same((v, c), p["want"])
    return dict(rank_array=(v, c, ovf), packed=packed.finish(),
                packed_n_runs=packed.n_runs)


# -- sequence shards -------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(13, 4), (3, 8), (0, 2), (100, 8), (7, 1),
                                 (2**20 + 3, 8)])
def test_sequence_shards_match_jax(n, k):
    got = pmesh.sequence_shards(n, k)
    assert got.dtype == np.int32
    assert np.array_equal(got, jmesh.sequence_shards(n, k))


@pytest.mark.parametrize("weights,k", [
    (np.array([200] * 32 + [10] * 800), 8), (np.ones(13), 4),
    (np.zeros(0), 3), (np.array([5, 1, 1, 1, 9, 2]), 8),
    (np.arange(1, 50), 2)])
def test_sequence_shards_weighted_match_jax(weights, k):
    got = pmesh.sequence_shards_weighted(weights, k)
    assert np.array_equal(got, jmesh.sequence_shards_weighted(weights, k))


def test_make_mesh_cpu_entries_and_too_few_gpus(monkeypatch):
    import torch

    assert pmesh.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert pmesh.mesh_devices(["cpu", torch.device("cpu")]) == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="empty"):
        pmesh.mesh_devices([])
    with pytest.raises(RuntimeError, match="is_available"):
        pmesh.make_mesh(2, "cuda")
    # a mesh of more GPUs than are visible raises; it never shrinks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError,
                       match=r"torch.cuda.device_count\(\) is 1"):
        pmesh.make_mesh(2, "cuda")


# -- the mesh searches -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_walk(pair):
    p = pair
    return jmesh.sharded_walk_packed_ra(
        p["ja_idx"], p["creads"], mesh=jmesh.make_mesh(8),
        a_sequences=p["n_a"]).finish()


@pytest.mark.parametrize("k", SIZES)
def test_sharded_walk_matches_jax(pair, jax_walk, k):
    p = pair
    stats = {}
    ra = pmesh.sharded_walk_packed_ra(p["pa_idx"], p["creads"], mesh=_cpu(k),
                                      a_sequences=p["n_a"], stats=stats)
    assert _same(ra.finish(), jax_walk) and _same(jax_walk, p["want"])
    # the snake deal: every lane dealt once, shard sizes within one lane
    lanes = stats["per_device_lanes"]
    assert sum(lanes) == p["n_b"] and max(lanes) - min(lanes) <= 1
    assert len(stats["per_device_runs"]) == k


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("k", SIZES)
def test_sharded_packed_ra_matches_jax(pair, jax_ra, k, streamed):
    p = pair
    stats = {}
    ra = pmesh.sharded_packed_ra(p["pa_idx"], p["pb_idx"], p["n_a"],
                                 p["n_b"], mesh=_cpu(k), streamed=streamed,
                                 stats=stats)
    assert ra.n_runs >= jax_ra["packed"][0].size       # shards may overlap
    # tiny chunks force boundary handling in the k-way merge
    parts = list(ra.stream(chunk_runs=173))
    prev_last = -1
    for pv, _ in parts:
        assert np.all(np.diff(pv) > 0) and pv[0] > prev_last
        prev_last = int(pv[-1])
    got = (np.concatenate([x[0] for x in parts]),
           np.concatenate([x[1] for x in parts]))
    assert _same(got, jax_ra["packed"])
    assert sum(stats["per_device_runs"]) == ra.n_runs


@pytest.mark.parametrize("k", SIZES)
def test_sharded_rank_array_matches_jax(pair, jax_ra, k):
    p = pair
    got = pmesh.sharded_rank_array(p["pa_idx"], p["pb_idx"], p["n_a"],
                                   p["n_b"], mesh=_cpu(k))
    assert got[2] is False
    assert _same(got[:2], jax_ra["rank_array"][:2])


def test_sharded_rank_array_sequence_offset(pair):
    # b_seq_offset shifts the searched ranks (a process's own block)
    p = pair
    v, c, _ = pmesh.sharded_rank_array(p["pa_idx"], p["pb_idx"], p["n_a"],
                                       5, mesh=_cpu(2), b_seq_offset=4)
    want = search_np.build_rank_array(
        p["ja"].rank_index, p["ja"].alpha.C.astype(np.int64),
        p["jb"].rank_index, p["jb"].alpha.C.astype(np.int64),
        p["n_a"], p["n_b"], b_seq_range=(4, 8))
    assert _same((v, c), want)


@pytest.fixture(scope="module")
def jax_dynamic(pair):
    from bwtmerge_tpu.ops.search_jax import RankArrayAccumulator

    p = pair
    acc = RankArrayAccumulator()
    jmesh.dynamic_block_search(p["ja_idx"], p["jb_idx"], p["n_a"], p["n_b"],
                               acc.emit, n_blocks=8, mesh=jmesh.make_mesh(2),
                               b_size=p["jb"].size())
    return acc.finish()


@pytest.mark.parametrize("k", SIZES)
def test_dynamic_block_search_matches_jax(pair, jax_dynamic, k):
    from bwtmerge_tpu_torch.models.spill import RankArraySpill

    p = pair
    acc = RankArraySpill()
    stats = {}
    pmesh.dynamic_block_search(p["pa_idx"], p["pb_idx"], p["n_a"], p["n_b"],
                               acc.emit, n_blocks=3 * k, mesh=_cpu(k),
                               stats=stats)
    assert _same(acc.finish(), jax_dynamic)
    assert stats["n_blocks"] == len(stats["per_block_runs"]) == min(3 * k,
                                                                    p["n_b"])
    assert len(stats["per_device_runs"]) == k
    assert sum(stats["per_device_runs"]) == sum(stats["per_block_runs"])


def test_dynamic_queue_balances_skewed_reads():
    """Base-weighted blocks from the dynamic queue keep the per-block
    emitted runs within 15% of the mean on pathologically skewed read
    lengths (the JAX package's test_dynamic_queue_balances_skewed_reads)."""
    from bwtmerge_tpu_torch.models.spill import RankArraySpill

    r = np.random.default_rng(0xB3714)
    b_seqs = ([r.integers(1, 5, size=120).astype(np.int64)
               for _ in range(16)]
              + [r.integers(1, 5, size=20).astype(np.int64)
                 for _ in range(960)])
    a_seqs = oracle.random_collection(r, 40, 30)
    ja, jb = (JFMI.from_runs(oracle.build_bwt(s)) for s in (a_seqs, b_seqs))
    want = search_np.build_rank_array(
        ja.rank_index, ja.alpha.C.astype(np.int64),
        jb.rank_index, jb.alpha.C.astype(np.int64),
        ja.sequences(), jb.sequences())
    pa, pb = FMI.from_runs(ja.runs), FMI.from_runs(jb.runs)
    lens = np.array([s.size for s in b_seqs], np.int64)
    acc = RankArraySpill()
    stats = {}
    pmesh.dynamic_block_search(pa.device_index("cpu"), pb.device_index("cpu"),
                               pa.sequences(), pb.sequences(), acc.emit,
                               n_blocks=8, mesh=_cpu(8), weights=lens + 1,
                               stats=stats)
    assert _same(acc.finish(), want)
    per = np.array(stats["per_block_runs"], np.float64)
    assert (per.max() - per.mean()) / per.mean() <= 0.15, per


def test_a_failing_shard_fails_the_call(pair, monkeypatch):
    # no shard is dropped: the first worker's exception raises, after all
    # workers have stopped
    p = pair
    calls = []
    real = pmesh.search_block_runs

    def flaky(a_idx, b_idx, rng, *args):
        calls.append(rng)
        if len(calls) == 2:
            raise RuntimeError("shard failed")
        return real(a_idx, b_idx, rng, *args)

    monkeypatch.setattr(pmesh, "search_block_runs", flaky)
    with pytest.raises(RuntimeError, match="shard failed"):
        pmesh.dynamic_block_search(p["pa_idx"], p["pb_idx"], p["n_a"],
                                   p["n_b"], lambda v, c: None, n_blocks=8,
                                   mesh=_cpu(3))
    with pytest.raises(RuntimeError, match="shard failed"):
        calls.clear()
        pmesh.sharded_packed_ra(p["pa_idx"], p["pb_idx"], p["n_a"], p["n_b"],
                                mesh=_cpu(4))


# -- verification and the block-sharded index -----------------------------------


@pytest.fixture(scope="module")
def patterns(pair):
    r = np.random.default_rng(5)
    seqs = pair["a_seqs"] + pair["b_seqs"]
    pats = [np.asarray(s[o:o + n]) for s, o, n in
            ((seqs[int(r.integers(len(seqs)))], int(r.integers(0, 5)),
              int(r.integers(1, 7))) for _ in range(37))]
    pats += [r.integers(1, 5, size=4) for _ in range(6)]
    max_len = max(x.size for x in pats)
    pat = np.zeros((len(pats), max_len), np.int32)
    lens = np.array([x.size for x in pats], np.int32)
    for i, x in enumerate(pats):
        pat[i, :x.size] = x
    return pat, lens


@pytest.fixture(scope="module")
def jax_counts(pair, patterns):
    import jax.numpy as jnp

    pat, lens = patterns
    idx = JIndex.build(pair["ja"].runs, pair["ja"].alpha.counts())
    got = np.asarray(jmesh.sharded_backward_search(
        idx, jnp.asarray(pat), jnp.asarray(lens), pat.shape[1],
        mesh=jmesh.make_mesh(8)))
    assert np.array_equal(got, [pair["ja"].count(p[:n])
                                for p, n in zip(pat, lens)])
    return got


@pytest.mark.parametrize("k", SIZES)
def test_sharded_backward_search_matches_jax(pair, patterns, jax_counts, k):
    pat, lens = patterns
    got = pmesh.sharded_backward_search(pair["pa_idx"], pat, lens,
                                        mesh=_cpu(k))
    assert got.dtype == np.int64 and np.array_equal(got, jax_counts)


@pytest.fixture(scope="module")
def jax_sharded_index(pair, patterns):
    import jax.numpy as jnp
    from bwtmerge_tpu.ops.rank_sharded import (ShardedFMIndex,
                                               wavefront_search_sharded)

    p = pair
    mesh = jmesh.make_mesh(8)
    ja_sh = ShardedFMIndex.build(p["ja"].runs, p["ja"].alpha.counts(),
                                 mesh=mesh)
    jb_sh = ShardedFMIndex.build(p["jb"].runs, p["jb"].alpha.counts(),
                                 mesh=mesh)
    q = np.random.default_rng(9).integers(
        0, p["ja"].size() + 1, size=300).astype(np.int32)
    q[:3] = (0, p["ja"].size(), 31)
    v, c, ovf = wavefront_search_sharded(ja_sh, jb_sh, mesh, 0,
                                         p["n_b"] - 1, p["n_a"],
                                         frontier_cap=2048, emit_cap=32768)
    assert not ovf
    # jitted: the eager shard_map of ranks_all takes seconds a call on the
    # CPU (and so does the JAX blocked search, one such call a character:
    # the port's is held against the JAX sharded_backward_search instead)
    ranks = jax.jit(lambda x: ja_sh.ranks_all(x, mesh))(jnp.asarray(q))
    return dict(q=q, ranks=np.asarray(ranks),
                wavefront=search_np.compact_rank_array(v, c))


@pytest.mark.parametrize("k", SIZES)
def test_sharded_fmi_ranks_all_matches_jax(pair, jax_sharded_index, k):
    p = pair
    idx = rank_sharded.ShardedFMIndex.build(p["pa"].runs,
                                            p["pa"].alpha.counts(),
                                            mesh=_cpu(k))
    assert idx.n_shards == k
    # each entry holds one slab, the slabs together the table
    nblk = p["pa"].size() // 32 + 1
    assert all(s.shape == (idx.slab, 16) for s in idx.slabs)
    assert idx.slab == -(-nblk // k)
    q = jax_sharded_index["q"]
    got = idx.ranks_all(q)
    assert np.array_equal(got.numpy(), jax_sharded_index["ranks"])
    assert np.array_equal(
        got.numpy(), p["pa_idx"].ranks_all(q.astype(np.int64)).numpy())
    assert np.array_equal(idx.LF_all(q).numpy(),
                          (p["pa_idx"].C[:8][None, :]
                           + p["pa_idx"].ranks_all(q.astype(np.int64))
                           ).numpy())


@pytest.mark.parametrize("k", SIZES)
def test_sharded_backward_search_blocked_matches_jax(pair, patterns,
                                                     jax_counts, k):
    p = pair
    pat, lens = patterns
    idx = rank_sharded.ShardedFMIndex.build(p["pa"].runs,
                                            p["pa"].alpha.counts(),
                                            mesh=_cpu(k))
    got = rank_sharded.sharded_backward_search_blocked(idx, pat, lens)
    assert got.dtype == np.int64 and np.array_equal(got, jax_counts)


@pytest.mark.parametrize("k", SIZES)
def test_wavefront_search_sharded_matches_jax(pair, jax_sharded_index, k):
    p = pair
    a_sh = rank_sharded.ShardedFMIndex.build(p["pa"].runs,
                                             p["pa"].alpha.counts(),
                                             mesh=_cpu(k))
    b_sh = rank_sharded.ShardedFMIndex.build(p["pb"].runs,
                                             p["pb"].alpha.counts(),
                                             mesh=_cpu(k))
    v, c, ovf = rank_sharded.wavefront_search_sharded(a_sh, b_sh, 0,
                                                      p["n_b"] - 1, p["n_a"])
    assert ovf is False
    assert _same((v, c), jax_sharded_index["wavefront"])
    # an empty block emits nothing
    assert rank_sharded.wavefront_search_sharded(a_sh, b_sh, 3, 2,
                                                 p["n_a"])[0].size == 0


# -- the merge over a mesh ---------------------------------------------------------


@pytest.fixture(scope="module")
def merge_pair(tmp_path_factory):
    """30 + 26 reads of 12-90 with B's sidecar, the JAX package's merged
    runs, and its streamed SGA file of the merge."""
    from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi_to_file

    d = tmp_path_factory.mktemp("mesh_merge")
    r = np.random.default_rng(31)
    a_seqs = oracle.random_collection(r, 30, 12, 90)
    b_seqs = oracle.random_collection(r, 26, 14, 90)
    ja = JFMI.from_runs(oracle.build_bwt(a_seqs))
    jb = JFMI.from_runs(oracle.build_bwt(b_seqs))
    want_file = str(d / "jax.sga")
    merge_fmi_to_file(ja, jb, want_file, "sga", MergeConfig(backend="numpy"))
    creads = creads_layout(np.array([s.size for s in b_seqs], np.uint32),
                           np.concatenate(b_seqs).astype(np.uint8))
    return dict(d=d, ja=ja, jb=jb, creads=creads, want_file=want_file,
                want=oracle.merge_collections([a_seqs, b_seqs]))


def _port_pair(mp):
    pa, pb = FMI.from_runs(mp["ja"].runs), FMI.from_runs(mp["jb"].runs)
    pb.attach_creads(mp["creads"])
    return pa, pb


@pytest.mark.parametrize("placement", ["replicated", "sharded"])
@pytest.mark.parametrize("k", SIZES)
def test_merge_fmi_devices(merge_pair, k, placement):
    pa, pb = _port_pair(merge_pair)
    for search in ("auto", "trie"):
        cfg = port.MergeConfig(device="cpu", devices=k, search=search,
                               index_placement=placement, sequence_blocks=3,
                               temp_dir=str(merge_pair["d"]))
        assert port.merge_fmi(pa, pb, cfg).runs == merge_pair["want"], search
    out = str(merge_pair["d"] / f"port_{k}_{placement}.sga")
    port.merge_fmi_to_file(pa, pb, out, "sga", port.MergeConfig(
        device="cpu", devices=_cpu(k), search="trie",
        index_placement=placement, sequence_blocks=1,
        temp_dir=str(merge_pair["d"])))
    with open(out, "rb") as f1, open(merge_pair["want_file"], "rb") as f2:
        assert f1.read() == f2.read()


def test_merge_routes_in_the_jax_order(merge_pair, monkeypatch):
    """Walk first where B has reads; then the sharded placement, then the
    dynamic queue (more sequence blocks than entries), then one block a
    shard; 'auto' places by the budget."""
    from bwtmerge_tpu_torch.models import merge as pm

    pa, pb = _port_pair(merge_pair)
    seen = []
    for name in ("sharded_walk_packed_ra", "dynamic_block_search",
                 "sharded_packed_ra"):
        real = getattr(pmesh, name)
        monkeypatch.setattr(pmesh, name, lambda *a, _n=name, _r=real, **kw:
                            seen.append(_n) or _r(*a, **kw))
    real_si = pm._sharded_index_search
    monkeypatch.setattr(pm, "_sharded_index_search", lambda *a: seen.append(
        "sharded_index") or real_si(*a))
    cases = [(dict(index_placement="sharded"), "sharded_walk_packed_ra"),
             (dict(search="trie", index_placement="sharded"),
              "sharded_index"),
             (dict(search="trie", hbm_budget_bytes=64), "sharded_index"),
             (dict(search="trie", sequence_blocks=5), "dynamic_block_search"),
             (dict(search="trie", sequence_blocks=2), "sharded_packed_ra")]
    for kw, route in cases:
        seen.clear()
        cfg = port.MergeConfig(device="cpu", devices=2, **kw)
        assert port.merge_fmi(pa, pb, cfg).runs == merge_pair["want"]
        assert seen == [route], (kw, seen)


# -- P.5: the rank array spills past its budget -----------------------------------


@pytest.mark.parametrize("devices", [1, 2])
@pytest.mark.parametrize("search", ["walk", "trie"])
def test_rank_array_spills_past_its_budget(merge_pair, tmp_path, monkeypatch,
                                           search, devices):
    """-r 0: no block fits the budget, every one drains into spill files
    under -d, and the merged bytes are those of the default budget; the
    default (8 Mi runs * 6) holds every block of this merge."""
    from bwtmerge_tpu_torch.models import spill

    pa, pb = _port_pair(merge_pair)
    made = []
    plain = spill.RankArraySpill._spill

    def counting(self):
        plain(self)
        made.append(self._files[-1].path)

    monkeypatch.setattr(spill.RankArraySpill, "_spill", counting)
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    outs = {}
    for budget in (0, None):
        cfg = port.MergeConfig(device="cpu", devices=devices, search=search,
                               device_blocks=3, temp_dir=str(spill_dir),
                               sequence_blocks=devices)
        if budget is not None:
            cfg.run_buffer_runs = budget
        made.clear()
        outs[budget] = str(tmp_path / f"out_{budget}.sga")
        port.merge_fmi_to_file(pa, pb, outs[budget], "sga", cfg)
        if budget == 0:
            # one file a block: three read blocks, or one block a shard
            assert len(made) == (3 if devices == 1 else 2)
            assert all(os.path.dirname(m) == str(spill_dir) for m in made)
        else:
            assert made == []
        assert os.listdir(spill_dir) == []        # the stream removed them
    with open(outs[0], "rb") as f1, open(outs[None], "rb") as f2:
        data = f1.read()
        assert data == f2.read()
    with open(merge_pair["want_file"], "rb") as f:
        assert data == f.read()


def test_blocked_ra_holds_within_budget_then_drains(tmp_path):
    import torch

    from bwtmerge_tpu_torch.models.spill import RankArraySpill
    from bwtmerge_tpu_torch.ops.ra_stream import BlockedRA

    r = np.random.default_rng(4)
    blocks = []
    for n in (50, 40, 30, 60, 10):
        v = np.unique(r.integers(0, 400, size=n)).astype(np.int64)
        blocks.append((v, r.integers(1, 5, size=v.size).astype(np.int64)))
    want = search_np.compact_rank_array(np.concatenate([b[0] for b in blocks]),
                                        np.concatenate([b[1] for b in blocks]))
    for budget in (None, 0, 80, 10**6):
        ra = BlockedRA(budget, lambda: RankArraySpill(
            temp_dir=str(tmp_path), compact_every=7))
        for v, c in blocks:
            ra.add(torch.from_numpy(v), torch.from_numpy(c))
        held = sum(len(b) for b in ra.blocks)
        assert held <= (budget if budget is not None else held)
        assert ra.n_runs == sum(b[0].size for b in blocks)
        assert (ra.n_spill_files > 0) == (held < ra.n_runs)
        assert _same(ra.finish(), want), budget


# -- launch counts under threads ---------------------------------------------------


def test_launch_count_exact_under_threads(monkeypatch):
    """Eight threads launch one kernel (a stub entry point: no card here)
    with a short switch interval: not one increment is lost."""
    import torch

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    stub = kernels.Kernel("stub", "stub.cu", [], "stub_error_string")
    stub._fn = lambda *args: 0
    per, n_threads = 4000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [stub.launch() for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert stub.launches == per * n_threads
    stub.reset()
    assert stub.launches == 0
    kernels.reset_launches()
    assert set(kernels.launches().values()) == {0}
