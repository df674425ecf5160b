"""The port's k-way fold (bwtmerge_tpu_torch/ops/kfold_torch.py,
models/kfold.py) against the JAX package's (ops/kfold_jax.py,
models/kfold.py), on the CPU.

Same numpy-seeded inputs into both packages: exact equality of the summed
lanes (mod 2^32, where the JAX package keeps uint32), of each lane block's
rank-array pairs, and of the merged runs and written bytes.  Duplicate reads
across pieces, identical pieces and single-character reads exercise the
endmarker tie convention hardest.  Every fold runs under a time bound, so a
hung drainer fails its test instead of the suite.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bwtmerge_tpu_torch as port  # noqa: E402
from bwtmerge_tpu.formats import read_bwt, write_bwt  # noqa: E402
from bwtmerge_tpu.formats.sidecar import creads_layout  # noqa: E402
from bwtmerge_tpu.models import kfold as jax_kfold  # noqa: E402
from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.models.build import build_from_reads  # noqa: E402
from bwtmerge_tpu.models.fmi import FMI as JaxFMI  # noqa: E402
from bwtmerge_tpu.models.merge import MergeConfig as JaxConfig  # noqa: E402
from bwtmerge_tpu.ops import kfold_jax, rank_jax  # noqa: E402
from bwtmerge_tpu.ops.search_jax import stream_packed_ra  # noqa: E402
from bwtmerge_tpu.ops.search_np import build_rank_array  # noqa: E402
from bwtmerge_tpu_torch.models import kfold as port_kfold  # noqa: E402
from bwtmerge_tpu_torch.ops import kfold_torch  # noqa: E402
from bwtmerge_tpu_torch.ops.rank_torch import (DeviceFMIndex,  # noqa: E402
                                               pack_nibbles_chunked)

SENT = 2**31 - 1


def within(seconds, fn, *args, **kwargs):
    """fn(*args, **kwargs) on a daemon thread; fails the calling test when
    it has not returned after `seconds`, and re-raises what it raised."""
    box = {}

    def target():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{fn.__name__} hung for {seconds} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _random_reads(rng, n, max_len=30):
    return [rng.integers(1, 6, size=int(rng.integers(1, max_len))
                         ).astype(np.uint8) for _ in range(n)]


def _runs(reads):
    return build_from_reads(reads, backend="numpy")[0]


def _dup_pieces(seed):
    rng = np.random.default_rng(seed)
    reads_list = [_random_reads(rng, int(rng.integers(2, 10)))
                  for _ in range(4)]
    reads_list[2][0] = reads_list[0][0].copy()
    reads_list[3][-1] = reads_list[1][0].copy()
    return reads_list


def _identical_pieces():
    reads = _random_reads(np.random.default_rng(7), 5, 12)
    return [list(reads) for _ in range(3)]


def _single_char_pieces():
    return [[np.array([2], np.uint8), np.array([3, 1], np.uint8)],
            [np.array([5], np.uint8)],
            [np.array([1], np.uint8), np.array([1], np.uint8)]]


CASES = {"dup0": lambda: _dup_pieces(0), "dup1": lambda: _dup_pieces(1),
         "dup2": lambda: _dup_pieces(2), "identical": _identical_pieces,
         "single_char": _single_char_pieces}


# -- B8: summed lanes and sort --------------------------------------------------


@pytest.mark.parametrize("beyond_int32", [False, True])
def test_summed_lanes_and_sort_match_jax(beyond_int32):
    # three walks' emissions over the same lanes (dead lanes SENT in each):
    # the port sums in int64, the JAX package in wrapping int32 read as
    # uint32; both agree mod 2^32 lane by lane, and so do the sorts
    rng = np.random.default_rng(31)
    n, walks = 1 << 10, 3
    dead = rng.random(n) < 0.2
    top = (2**32 - 3) // walks if beyond_int32 else 1 << 20
    emits = [np.where(dead, SENT, rng.integers(0, min(top, SENT), size=n)
                      ).astype(np.int32) for _ in range(walks)]
    j_total = kfold_jax._first_lanes(jnp.asarray(emits[0]))
    t_total = kfold_torch._first_lanes(torch.from_numpy(emits[0]))
    for e in emits[1:]:
        j_total = kfold_jax._sum_lanes(j_total, jnp.asarray(e))
        t_total = kfold_torch._sum_lanes(t_total, torch.from_numpy(e))
    j_u32 = np.asarray(j_total).view(np.uint32).astype(np.int64)
    assert t_total.dtype == torch.int64
    np.testing.assert_array_equal(t_total.numpy() % 2**32, j_u32)
    live = t_total[t_total != kfold_torch.DEAD]
    assert bool((live >= 2**31).any()) == beyond_int32
    j_sorted = np.asarray(kfold_jax._sort_vals(j_total)).view(np.uint32)
    t_sorted = kfold_torch._sort_vals(t_total).numpy()
    np.testing.assert_array_equal(t_sorted % 2**32, j_sorted)
    assert (t_sorted[-int(dead.sum()):] == kfold_torch.DEAD).all()


def _packed_pairs(part):
    dc8, meta, exc4, esc = part
    got = list(stream_packed_ra(dc8, meta, exc4, chunk_runs=64, esc=esc))
    return (np.concatenate([v for v, _ in got]),
            np.concatenate([c for _, c in got]))


@pytest.mark.parametrize("n_targets", [1, 2])
def test_part_pair_streams_match_jax(monkeypatch, n_targets):
    # 128 reads with one of the longest length, and a lane budget of 32
    # reads: both packages cut the same four lane blocks, and each block's
    # pairs must agree, the root run included
    rng = np.random.default_rng(21 + n_targets)
    max_len = 10
    reads_b = _random_reads(rng, 128, max_len)
    reads_b[5] = rng.integers(1, 6, size=max_len - 1).astype(np.uint8)
    creads = creads_layout(np.array([r.size for r in reads_b], np.uint32),
                           np.concatenate(reads_b))
    lanes = creads.shape[0] * 32
    monkeypatch.setattr(kfold_jax, "MAX_WALK_LANES", lanes)
    monkeypatch.setattr(kfold_torch, "MAX_WALK_LANES", lanes)
    pieces = [JaxFMI.from_runs(_runs(_random_reads(rng, 9, 30)))
              for _ in range(n_targets)]
    j_targets = [kfold_jax.PieceIndex.from_device_index(p.device_index)
                 for p in pieces]
    t_targets = [kfold_torch.PieceIndex.from_device_index(
        DeviceFMIndex.build(p.runs, p.alpha.counts(), "cpu")) for p in pieces]
    want = [_packed_pairs(p)
            for p in kfold_jax.summed_packed_parts(j_targets, creads)]
    got = kfold_torch.summed_parts(t_targets, creads)
    assert len(got) == len(want) == 4
    for (gv, gc), (wv, wc) in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_array_equal(gc.numpy(), wc)
    if n_targets == 1:
        # the blocks' union is the trie oracle's rank array
        a = pieces[0]
        b = JaxFMI.from_runs(_runs(reads_b))
        wv, wc = build_rank_array(a.rank_index, a.alpha.C.astype(np.int64),
                                  b.rank_index, b.alpha.C.astype(np.int64),
                                  a.sequences(), b.sequences())
        v = np.concatenate([g[0].numpy() for g in got])
        c = np.concatenate([g[1].numpy() for g in got])
        uv, inv = np.unique(v, return_inverse=True)
        np.testing.assert_array_equal(uv, wv)
        np.testing.assert_array_equal(np.bincount(inv, weights=c), wc)


def test_fold_total_guard():
    class Huge:
        cpl = torch.zeros((5, 2), dtype=torch.int32)
        size = kfold_torch.MAX_FOLD_TOTAL
        sequences = 1

    with pytest.raises(ValueError, match="2\\^32"):
        kfold_torch.summed_part_thunks([Huge()], np.ones((3, 4), np.int8))


# -- models/kfold: in-memory and file folds -------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_fmi_many_matches_jax(tmp_path, case):
    reads_list = CASES[case]()
    runs = [_runs(r) for r in reads_list]
    want = jax_kfold.merge_fmi_many(
        [JaxFMI.from_runs(r) for r in runs],
        JaxConfig(backend="jax", temp_dir=str(tmp_path)))
    got = within(120, port.merge_fmi_many,
                 [port.FMI.from_runs(r) for r in runs],
                 port.MergeConfig(device="cpu", temp_dir=str(tmp_path)))
    assert got.runs == want.runs
    np.testing.assert_array_equal(got.alpha.C, want.alpha.C)
    assert got.hash() == want.hash()


def test_many_lane_blocks_drain_under_thread_switching(tmp_path,
                                                       monkeypatch):
    # one lane block per read: each step's blocks drain through two worker
    # threads into one shared spill and block count; with the interpreter
    # switching threads every microsecond a lost update would change the
    # merged runs
    reads_list = _dup_pieces(3)
    runs = [_runs(r) for r in reads_list]
    want = jax_kfold.merge_fmi_many(
        [JaxFMI.from_runs(r) for r in runs],
        JaxConfig(backend="jax", temp_dir=str(tmp_path)))
    monkeypatch.setattr(kfold_torch, "MAX_WALK_LANES", 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = within(120, port.merge_fmi_many,
                     [port.FMI.from_runs(r) for r in runs],
                     port.MergeConfig(device="cpu", temp_dir=str(tmp_path)))
    finally:
        sys.setswitchinterval(interval)
    assert got.runs == want.runs


def test_merge_fmi_many_mismatched_alphabet(tmp_path):
    from bwtmerge_tpu.utils.alphabet import AlphabeticOrder, create_alphabet

    rng = np.random.default_rng(8)
    a = port.FMI.from_runs(_runs(_random_reads(rng, 3)))
    b = port.FMI.from_runs(_runs(_random_reads(rng, 3)))
    sorted_alpha = create_alphabet(AlphabeticOrder.SORTED)
    sorted_alpha.C = b.alpha.C.copy()
    b.alpha = sorted_alpha
    with pytest.raises(ValueError, match="alphabet"):
        port.merge_fmi_many([a, b, a], port.MergeConfig(device="cpu"))


def _write_pieces(tmp_path, reads_list, fmt="sga"):
    paths = []
    for i, reads in enumerate(reads_list):
        f = JaxFMI.from_runs(_runs(reads))
        p = str(tmp_path / f"p{i}.{fmt}")
        write_bwt(p, fmt, f.runs, f.alpha)
        paths.append(p)
    return paths


def _leftovers(tmp_path):
    return sorted(n for n in os.listdir(tmp_path) if n.startswith("."))


@pytest.mark.parametrize("chain,n_pieces,out_fmt", [
    ("threads", 3, "native"), ("procs", 3, "sga"), ("threads", 5, "sga"),
    ("procs", 4, "native")])
def test_merge_files_many_matches_jax(tmp_path, chain, n_pieces, out_fmt):
    rng = np.random.default_rng(40 + n_pieces)
    reads_list = [_random_reads(rng, int(rng.integers(3, 12)))
                  for _ in range(n_pieces)]
    reads_list[-1][0] = reads_list[0][-1].copy()
    paths = _write_pieces(tmp_path, reads_list)
    want = str(tmp_path / f"jax.{out_fmt}")
    jax_kfold.merge_files_many(paths, want, "sga", out_fmt,
                               JaxConfig(backend="jax",
                                         temp_dir=str(tmp_path)),
                               window_positions=256)
    got = str(tmp_path / f"port.{out_fmt}")
    stats = {}
    within(120, port.merge_files_many, paths, got, "sga", out_fmt,
           port.MergeConfig(device="cpu", temp_dir=str(tmp_path)),
           window_positions=256, stats=stats, chain=chain)
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
    assert stats["fold_steps"] == n_pieces - 1
    assert stats["piece_bases"] == [read_bwt(p, "sga")[0].size()
                                    for p in paths]
    assert _leftovers(tmp_path) == []        # no temp output, no spill file


def test_merge_files_many_two_inputs_matches_jax(tmp_path):
    # two inputs take the pairwise merge_files; B needs its reads, here
    # decoded on the device under search='walk'
    rng = np.random.default_rng(50)
    paths = _write_pieces(tmp_path, [_random_reads(rng, 6),
                                     _random_reads(rng, 5)])
    want = str(tmp_path / "jax.sga")
    jax_kfold.merge_files_many(paths, want, "sga", "sga",
                               JaxConfig(backend="jax",
                                         temp_dir=str(tmp_path)))
    got = str(tmp_path / "port.sga")
    stats = {}
    port.merge_files_many(paths, got, "sga", "sga",
                          port.MergeConfig(device="cpu", search="walk",
                                           temp_dir=str(tmp_path)),
                          stats=stats)
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
    assert stats["piece_bases"] == [read_bwt(p, "sga")[0].size()
                                    for p in paths]


# -- faults of the JAX package the port avoids ---------------------------------


def _chunks_with_equal_neighbours(rng, n):
    """(syms, lens) chunks whose runs are NOT maximal: equal neighbours
    inside a chunk and across seams, and zero-length runs."""
    syms = rng.integers(0, 6, size=n).astype(np.uint8)
    syms[10:14] = 3
    lens = rng.integers(0, 5, size=n).astype(np.int64)
    lens[11] = 0
    cuts = np.sort(rng.choice(np.arange(1, n), size=6, replace=False))
    return [(s, l) for s, l in zip(np.split(syms, cuts), np.split(lens, cuts))]


def test_pack_nibbles_chunked_matches_build_and_counts_runs(rng):
    # C.3: rank_jax.pack_nibbles_chunked merges equal neighbours only at
    # chunk seams, so its n_runs overcounts; the port's copy is exact
    chunks = _chunks_with_equal_neighbours(rng, 400)
    syms = np.concatenate([s for s, _ in chunks])
    lens = np.concatenate([l for _, l in chunks])
    text = np.repeat(syms, lens)
    true_runs = int(np.count_nonzero(np.diff(text)) + 1)
    nib, counts, size, n_runs = pack_nibbles_chunked(chunks)
    assert (size, n_runs) == (text.size, true_runs)
    np.testing.assert_array_equal(counts, np.bincount(text, minlength=6))
    j_nib, _, j_size, j_runs = rank_jax.pack_nibbles_chunked(chunks)
    assert j_size == size and j_runs > n_runs
    np.testing.assert_array_equal(nib, j_nib[:nib.size])
    assert nib.size == (size // 32 + 1) * 16

    f = port.FMI.from_runs(_runs(_random_reads(rng, 30, 40)))
    built = DeviceFMIndex.build(f.runs, f.alpha.counts(), "cpu")
    nib, counts, size, n_runs = pack_nibbles_chunked(f.runs.iter_chunks(97))
    assert (size, n_runs) == (f.size(), f.runs.n_runs)
    packed = DeviceFMIndex.from_nibbles(nib, counts, size, n_runs, "cpu")
    assert torch.equal(packed.rec, built.rec)
    assert torch.equal(packed.C, built.C)


@pytest.mark.parametrize("chain", ["threads", "procs"])
def test_failing_loader_neither_hangs_nor_writes(tmp_path, chain):
    # C.1 and C.2: a piece that fails to load (a torn file) fails the fold
    # promptly, and the output path is never created
    rng = np.random.default_rng(60)
    paths = _write_pieces(tmp_path, [_random_reads(rng, 6)
                                     for _ in range(4)])
    with open(paths[2], "r+b") as f:
        f.truncate(os.path.getsize(paths[2]) // 2)
    out = tmp_path / "out.sga"
    with pytest.raises(Exception):
        within(60, port.merge_files_many, paths, str(out), "sga", "sga",
               port.MergeConfig(device="cpu", temp_dir=str(tmp_path)),
               chain=chain)
    assert not out.exists()
    assert _leftovers(tmp_path) == []


def test_piece_too_long_names_slice_3(tmp_path, monkeypatch, capfd):
    _piece_too_long_takes_the_trie_chain(tmp_path, monkeypatch, capfd,
                                         "threads")


def test_piece_too_long_takes_the_trie_chain_from_procs(tmp_path, monkeypatch,
                                                        capfd):
    _piece_too_long_takes_the_trie_chain(tmp_path, monkeypatch, capfd,
                                         "procs")


def test_merge_fmi_many_piece_too_long_matches_jax(tmp_path, monkeypatch,
                                                   capfd):
    # the in-memory fold takes the same way out: pairwise merge_fmi on the
    # trie search, to the JAX package's runs
    monkeypatch.setattr(port_kfold, "WALK_MAX_LEN", 64)
    rng = np.random.default_rng(62)
    reads_list = [_random_reads(rng, 5) for _ in range(3)]
    reads_list[2].append(rng.integers(1, 6, size=150).astype(np.uint8))
    runs = [oracle.build_bwt(r) for r in reads_list]
    got = within(120, port.merge_fmi_many,
                 [port.FMI.from_runs(r) for r in runs],
                 port.MergeConfig(device="cpu", temp_dir=str(tmp_path)))
    assert "falling back to the pairwise chain" in capfd.readouterr().err
    assert got.runs == oracle.merge_collections(reads_list)
    trie = within(120, port.merge_fmi_many,
                  [port.FMI.from_runs(r) for r in runs],
                  port.MergeConfig(device="cpu", temp_dir=str(tmp_path),
                                   search="trie"))
    assert trie.runs == got.runs


def _piece_too_long_takes_the_trie_chain(tmp_path, monkeypatch, capfd, chain):
    # a piece with a read the walk cannot take sends the fold to the
    # pairwise chain with the trie search (the port's cap is lowered to 64
    # so that a read of 150 passes it); the chain's bytes are the JAX
    # package's fold's
    monkeypatch.setattr(port_kfold, "WALK_MAX_LEN", 64)
    rng = np.random.default_rng(61)
    reads_list = [_random_reads(rng, 5) for _ in range(3)]
    reads_list[1].append(rng.integers(1, 6, size=150).astype(np.uint8))
    paths = _write_pieces(tmp_path, reads_list)
    want = str(tmp_path / "jax.sga")
    jax_kfold.merge_files_many(paths, want, "sga", "sga",
                               JaxConfig(backend="jax",
                                         temp_dir=str(tmp_path)))
    capfd.readouterr()
    out = tmp_path / "out.sga"
    stats = {}
    within(120, port.merge_files_many, paths, str(out), "sga", "sga",
           port.MergeConfig(device="cpu", temp_dir=str(tmp_path)),
           stats=stats, chain=chain)
    assert "falling back to the pairwise chain" in capfd.readouterr().err
    with open(out, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
    assert stats["piece_bases"] == [read_bwt(p, "sga")[0].size()
                                    for p in paths]        # C.4
    assert _leftovers(tmp_path) == []


def test_drainer_push_never_blocks_after_failure(tmp_path):
    # C.1: once the drainer has died, push and fail raise or return; they
    # never wait on the full queue
    class Broken:
        def step_part_thunks(self, k, creads):
            raise RuntimeError("step dispatch failed")

    steps = port_kfold._StepDrainer(Broken(), 4, str(tmp_path))

    def push_all():
        for _ in range(4):
            steps.push(torch.zeros((1, 1), dtype=torch.int8))

    with pytest.raises(RuntimeError, match="step dispatch failed"):
        within(30, push_all)
    within(5, steps.fail, RuntimeError("again"))
    with pytest.raises(RuntimeError, match="step dispatch failed"):
        within(5, steps.wait_spill, 3)
