"""The port's xlarge tier (bwtmerge_tpu_torch/xlarge/) against the JAX
tree's recipe, on the CPU at a small scale.

The JAX tree's `scripts/build_xlarge_fixtures.py` and `build_big_pieces.py`
run their recipe when imported, with fixed paths, so the JAX side here is
that recipe written out with the JAX package's own functions
(build_from_reads(backend="jax"), merge_fmi, write_sidecar, the streaming
native writer, kfold.merge_files_many).  Pieces of 2,000 reads (seeds as
at full scale), a base of two folds: every file the two sides write must be
byte-identical.  Then the port's checks among themselves: the device
layout's counts against the host's block-sampled rank, the pairwise route
against the k-way fold, a resumed base build, the bench's record.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from bwtmerge_tpu.formats import read_bwt as jax_read_bwt  # noqa: E402
from bwtmerge_tpu.formats import write_bwt as jax_write_bwt  # noqa: E402
from bwtmerge_tpu.formats.sidecar import sidecar_path  # noqa: E402
from bwtmerge_tpu.formats.sidecar import write_sidecar  # noqa: E402
from bwtmerge_tpu.formats.streaming import write_bwt_stream  # noqa: E402
from bwtmerge_tpu.models import kfold as jax_kfold  # noqa: E402
from bwtmerge_tpu.models.build import build_from_reads  # noqa: E402
from bwtmerge_tpu.models.fmi import FMI as JaxFMI  # noqa: E402
from bwtmerge_tpu.models.merge import MergeConfig as JaxConfig  # noqa: E402
from bwtmerge_tpu.models.merge import merge_fmi as jax_merge_fmi  # noqa: E402
from bwtmerge_tpu.utils.alphabet import Alphabet as JaxAlphabet  # noqa: E402
from bwtmerge_tpu_torch.models.kfold import merge_files_many  # noqa: E402
from bwtmerge_tpu_torch.models.merge import MergeConfig  # noqa: E402
from bwtmerge_tpu_torch.models.merge import merge_files  # noqa: E402
from bwtmerge_tpu_torch.ops.rank_torch import (MAX_SIZE,  # noqa: E402
                                               DeviceFMIndex)
from bwtmerge_tpu_torch.xlarge import bench, big_pieces, fixtures  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()

READS = 2_000
BASE_SEEDS = (202, 203)                 # a base of two folds
PIECES = (201, 202, 203, 208, 209)
BIG_GROUPS = {"xl_big_1": (201, 202, 203), "xl_big_2": (208, 209, 201)}


def _jax_piece(cache, seed):
    """scripts/build_xlarge_fixtures.py:piece with the JAX package."""
    path = os.path.join(cache, f"xl_piece_{seed}.sga")
    flat, lens = fixtures.piece_reads(seed, READS)
    runs, _ = build_from_reads((flat, lens), rlo=False, backend="jax")
    jax_write_bwt(path, "sga", runs,
                  JaxAlphabet.from_counts(runs.counts(6)))
    write_sidecar(sidecar_path(path), lens.astype(np.uint32),
                  flat.astype(np.uint8))
    return path


def _jax_base(cache, pieces):
    """scripts/build_xlarge_fixtures.py's left fold with merge_fmi."""
    cfg = JaxConfig(backend="jax", temp_dir=cache, search="auto")
    p0 = pieces[fixtures.FIRST_SEED]
    runs, _, alpha = jax_read_bwt(p0, "sga")
    acc = JaxFMI(runs=runs, alpha=alpha, creads_path=sidecar_path(p0))
    for seed in BASE_SEEDS:
        runs, _, alpha = jax_read_bwt(pieces[seed], "sga")
        ins = JaxFMI(runs=runs, alpha=alpha,
                     creads_path=sidecar_path(pieces[seed]))
        acc = jax_merge_fmi(acc, ins, cfg)

    def chunks():
        step = 1 << 22
        for s in range(0, acc.runs.syms.size, step):
            yield acc.runs.syms[s:s + step], acc.runs.lens[s:s + step]

    path = os.path.join(cache, "xl_base.native")
    write_bwt_stream(path, "native", chunks(), acc.alpha)
    return path


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    """Both sides' fixtures and folds: {"port": {...}, "jax": {...}} of
    file paths, plus the port's cache."""
    port_dir = str(tmp_path_factory.mktemp("xl_port"))
    jax_dir = str(tmp_path_factory.mktemp("xl_jax"))
    fixtures.build(port_dir, READS, "cpu", BASE_SEEDS, (208, 209))
    big_pieces.build(port_dir, READS, "cpu", BIG_GROUPS)
    port = {f"piece_{s}": fixtures.piece_path(port_dir, s, READS)
            for s in PIECES}
    port["base"] = fixtures.base_path(port_dir, len(BASE_SEEDS), READS)
    for name in BIG_GROUPS:
        port[name] = big_pieces.big_path(port_dir, name, READS)

    jax = {f"piece_{s}": _jax_piece(jax_dir, s) for s in PIECES}
    jax["base"] = _jax_base(jax_dir, {s: jax[f"piece_{s}"] for s in PIECES})
    for name, seeds in BIG_GROUPS.items():
        jax[name] = os.path.join(jax_dir, f"{name}.native")
        jax_kfold.merge_files_many([jax[f"piece_{s}"] for s in seeds],
                                   jax[name], "sga", "native",
                                   JaxConfig(backend="jax", temp_dir=jax_dir))

    folds = {"3way": ["piece_209", "piece_208"],
             "big": list(BIG_GROUPS)}
    for key, inserts in folds.items():
        fmts = ["native"] + ["native" if k.startswith("xl_big") else "sga"
                             for k in inserts]
        for files, d, fold, cfg in (
                (port, port_dir, merge_files_many,
                 MergeConfig(device="cpu", temp_dir=port_dir, search="auto")),
                (jax, jax_dir, jax_kfold.merge_files_many,
                 JaxConfig(backend="jax", temp_dir=jax_dir, search="auto"))):
            out = os.path.join(d, f"fold_{key}.native")
            fold([files[k] for k in ["base", *inserts]], out, fmts,
                 "native", cfg)
            files[f"fold_{key}"] = out
    port["cache"] = port_dir
    return {"port": port, "jax": jax}


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("key", [f"piece_{s}" for s in PIECES]
                         + ["base", *BIG_GROUPS, "fold_3way", "fold_big"])
def test_files_match_jax(tier, key):
    got, want = tier["port"][key], tier["jax"][key]
    assert os.path.getsize(got) > 0
    assert _same_bytes(got, want), key
    if key.startswith("piece_"):
        assert _same_bytes(sidecar_path(got), sidecar_path(want)), key


@pytest.mark.parametrize("key", ["fold_3way", "fold_big"])
def test_device_counts_equal_sparse_rank_counts(tier, key):
    """The two verification routes of the bench on one output, with the
    read-derived 32-mers and with strings of several lengths."""
    cache = tier["port"]["cache"]
    pats = bench.read_patterns(cache, READS)
    words = ["ACGT", "A", "TTTTTTTT", "GATTACA", "CCCCCCCCCCCCCCCCCCCCCCCCC"]
    sets = [list(pats), words]
    on_device, size = bench.device_counts(tier["port"][key], "native", sets,
                                          "cpu")
    on_host, host_size = bench.host_counts(tier["port"][key], "native", sets)
    assert size == host_size > 0
    assert (on_device[0] >= 1).all()      # each 32-mer was cut from a read
    assert on_device[1][0] > 0 and on_device[1][-1] == 0
    for d, h in zip(on_device, on_host):
        np.testing.assert_array_equal(d, h)


@pytest.mark.parametrize("stride", [1, 7, 4096])
def test_sparse_rank_from_chunks_matches_build(tier, stride):
    """The bench's host index (uint32 run lengths, built from the chunk
    stream) answers as SparseRankIndex.build over the run arrays does, at
    strides that do and do not divide the chunks."""
    from bwtmerge_tpu_torch.formats import read_bwt
    from bwtmerge_tpu_torch.formats.streaming_read import read_bwt_chunks
    from bwtmerge_tpu_torch.ops.rank_np import SparseRankIndex

    path = tier["port"]["fold_3way"]
    runs = read_bwt(path, "native")[0]
    want = SparseRankIndex.build(runs, 6, stride)
    got = SparseRankIndex.from_chunks(read_bwt_chunks(path, "native",
                                                      chunk_bytes=4096),
                                      6, stride)
    assert got.lens.dtype == np.uint32
    np.testing.assert_array_equal(got.blk_starts, want.blk_starts)
    np.testing.assert_array_equal(got.blk_occ, want.blk_occ)
    rng = np.random.default_rng(stride)
    pos = rng.integers(0, runs.size() + 1, size=300)
    comp = rng.integers(0, 6, size=300)
    np.testing.assert_array_equal(got.rank(pos, comp), want.rank(pos, comp))
    inside = pos[pos < runs.size()]
    for g, w in zip(got.inverse_select(inside), want.inverse_select(inside)):
        np.testing.assert_array_equal(g, w)


def test_sparse_rank_from_chunks_refuses_a_run_past_uint32():
    from bwtmerge_tpu_torch.ops.rank_np import SparseRankIndex

    with pytest.raises(ValueError, match="2\\^32"):
        SparseRankIndex.from_chunks(iter([(np.array([1], np.uint8),
                                           np.array([2**32], np.int64))]))


@pytest.mark.parametrize("chain", ["procs", "threads"])
def test_fold_with_lane_blocks_and_spill_files_matches(tier, tmp_path,
                                                       monkeypatch, chain):
    """A fold step of several lane blocks drains into several spill files
    whose value ranges overlap (each block spans the whole range); the
    chain must merge them, not read them one after the other.  The big-
    piece tier's steps (10 M reads: two lane blocks, 6-8 spill files) wrote
    a corrupt file on the card through the subprocess chain."""
    from bwtmerge_tpu_torch.models import kfold as port_kfold
    from bwtmerge_tpu_torch.ops import kfold_torch

    monkeypatch.setattr(kfold_torch, "MAX_WALK_LANES", 2000)
    monkeypatch.setattr(port_kfold, "SPILL_THRESHOLD_RUNS", 1000)
    monkeypatch.setattr(port_kfold, "COMPACT_EVERY_RUNS", 500)
    monkeypatch.setattr(port_kfold, "DRAIN_CHUNK_RUNS", 300)
    port = tier["port"]
    out = str(tmp_path / "fold.native")
    stats = {}
    merge_files_many([port["base"], port["piece_209"], port["piece_208"]],
                     out, ["native", "sga", "sga"], "native",
                     MergeConfig(device="cpu", temp_dir=str(tmp_path)),
                     stats=stats, chain=chain)
    assert min(stats["step_spill_files"]) > 2
    assert _same_bytes(out, port["fold_3way"])
    assert sorted(os.listdir(tmp_path)) == ["fold.native"]


@pytest.mark.parametrize("order", ["fold_order", "other_order"])
def test_pairwise_route_matches_kway(tier, tmp_path, order):
    """merge_files(base, first insert) then merge_files(that, second) in the
    fold's input order writes the fold's bytes; in the other order the
    read order, and so the bytes, differ (the symbol counts do not)."""
    port = tier["port"]
    first, second = (("piece_209", "piece_208") if order == "fold_order"
                     else ("piece_208", "piece_209"))
    cfg = MergeConfig(device="cpu", temp_dir=str(tmp_path), search="auto")
    mid, out = str(tmp_path / "mid.native"), str(tmp_path / "out.native")
    merge_files(port["base"], port[first], mid, "native", "native", cfg,
                in_fmt_b="sga")
    merge_files(mid, port[second], out, "native", "native", cfg,
                in_fmt_b="sga")
    assert _same_bytes(out, port["fold_3way"]) == (order == "fold_order")
    from bwtmerge_tpu_torch.formats import read_bwt

    np.testing.assert_array_equal(
        read_bwt(out, "native")[0].counts(6),
        read_bwt(port["fold_3way"], "native")[0].counts(6))


@pytest.mark.parametrize("tier_args", [{"pieces": 2}, {"pieces": 3},
                                       {"big": 2}])
def test_bench_record(tier, tmp_path, tier_args):
    """bench.run over the cached fixtures: the JAX script's fields, the
    invariant held for its 32-mers and for a further pattern set, the sizes
    summed; a third piece (207) is built."""
    cache = str(tmp_path / "xl")
    shutil.copytree(tier["port"]["cache"], cache)
    words = ["ACGTACGT", "GATTACA", "TTT"]
    rec = bench.run(cache, READS, base_folds=len(BASE_SEEDS), device="cpu",
                    more_patterns=[words], **tier_args)
    json.dumps(rec)
    extra = rec["extra"]
    n_in = 1 + tier_args.get("pieces", tier_args.get("big"))
    assert rec["metric"] == f"xlarge {n_in}-way fold throughput"
    assert extra["invariant_ok"] and extra["verify_route"] == "device"
    assert extra["device"] == "cpu" and extra["peak_device_GB"] is None
    assert extra["patterns"] == 2 * bench.PATTERN_COLUMNS
    assert extra["more_patterns"][0]["patterns"] == len(words)
    assert extra["more_patterns"][0]["occurrences"] > 0
    assert extra["total_bases"] == extra["base_bases"] + extra["insert_bases"]
    assert extra["base_bases"] == READS * 51 * (1 + len(BASE_SEEDS))
    if "big" not in tier_args:
        assert extra["insert_bases"] == READS * 51 * tier_args["pieces"]
    assert len(extra["step_drained_s"]) == n_in - 1
    assert set(extra["phase_s"]) == {"device fold dispatch",
                                     "fold chain (interleave+write)"}
    assert extra["fold_s"] > 0 and extra["peak_rss_GB"] > 0
    built = [s["step"] for s in extra["fixture_steps"]]
    assert built == (["piece 207"] if tier_args.get("pieces") == 3 else [])
    assert not os.path.exists(os.path.join(cache, "xl_merged.native"))


def test_base_build_resumes_from_its_checkpoint(tier, tmp_path):
    """A base build killed after its first fold resumes from that fold's
    checkpoint and writes the cold build's bytes."""
    src = tier["port"]["cache"]
    cache = str(tmp_path)
    for s in PIECES:
        for suffix in ("", ".reads4"):
            shutil.copy(fixtures.piece_path(src, s, READS) + suffix, cache)
    one = fixtures.build_base(cache, READS, "cpu", BASE_SEEDS[:1])
    os.replace(one, fixtures.checkpoint_path(cache, 1, READS))
    steps = []
    two = fixtures.build_base(cache, READS, "cpu", BASE_SEEDS, steps)
    assert [s["step"] for s in steps] == [f"fold +{BASE_SEEDS[1]}"]
    assert _same_bytes(two, tier["port"]["base"])
    assert sorted(os.listdir(cache)) == sorted(
        [os.path.basename(two)] + [os.path.basename(
            fixtures.piece_path(cache, s, READS)) + x for s in PIECES
            for x in ("", ".reads4")])


@pytest.mark.parametrize("kind", ["piece", "base", "big"])
def test_cached_files_of_another_read_count_are_not_reused(tier, tmp_path,
                                                           kind):
    """A cache shared by two read counts: a build at the other count writes
    files of its own size beside those of the first, which stay as they
    were."""
    from bwtmerge_tpu_torch.formats import read_bwt

    cache = str(tmp_path / "xl")
    shutil.copytree(tier["port"]["cache"], cache)
    before = {f: os.path.getsize(os.path.join(cache, f))
              for f in os.listdir(cache)}
    half = READS // 2
    if kind == "piece":
        path, fmt, n_pieces = fixtures.build_piece(cache, 209, half,
                                                   "cpu"), "sga", 1
    elif kind == "base":
        path, fmt, n_pieces = fixtures.build_base(
            cache, half, "cpu", BASE_SEEDS), "native", 1 + len(BASE_SEEDS)
    else:
        group = {"xl_big_1": BIG_GROUPS["xl_big_1"]}
        (path,) = big_pieces.build(cache, half, "cpu", group)
        fmt, n_pieces = "native", len(group["xl_big_1"])
    assert os.path.basename(path) not in before
    assert read_bwt(path, fmt)[0].size() == half * 51 * n_pieces
    for f, size in before.items():
        assert os.path.getsize(os.path.join(cache, f)) == size, f


def test_device_layout_limit():
    """MAX_SIZE positions fit the device layout; one more raises in the
    index build."""
    assert MAX_SIZE == 2**31 - 2
    with pytest.raises(ValueError, match="exceeds int32 device layout"):
        DeviceFMIndex.from_nibbles(np.zeros(16, np.uint8), np.zeros(6),
                                   MAX_SIZE + 1, device="cpu")


@pytest.mark.parametrize("past", [0, 1])
def test_bench_leaves_the_device_at_the_layout_limit(tier, tmp_path,
                                                     monkeypatch, past):
    """An output of MAX_SIZE positions is counted on the device, one of a
    position more by the host's SparseRankIndex (bench_xlarge.py tests
    < 2^31 instead, which sends 2^31 - 1 positions to a device layout that
    refuses them)."""
    from bwtmerge_tpu_torch.ops import rank_torch

    cache = str(tmp_path / "xl")
    shutil.copytree(tier["port"]["cache"], cache)
    total = READS * 51 * (1 + len(BASE_SEEDS) + 2)
    monkeypatch.setattr(rank_torch, "MAX_SIZE", total - past)
    rec = bench.run(cache, READS, base_folds=len(BASE_SEEDS), device="cpu")
    assert rec["extra"]["total_bases"] == total
    assert rec["extra"]["verify_route"] == ("host SparseRankIndex" if past
                                            else "device")
    assert rec["extra"]["invariant_ok"]


def test_cuda_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for call in (lambda: bench.run(str(tmp_path), READS, device="cuda"),
                 lambda: fixtures.build(str(tmp_path), READS, "cuda"),
                 lambda: big_pieces.build(str(tmp_path), READS, "cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv", [["--pieces", "0"], ["--big", "7"],
                                  ["--base-folds", "0"],
                                  ["--pieces", "2", "--big", "2"]])
def test_bench_cli_rejects_bad_tiers(argv, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
