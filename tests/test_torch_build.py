"""BWT construction of the port (bwtmerge_tpu_torch/ops/sa_torch.py,
models/build.py, cli/bwt_build.py) against the JAX package's
(bwtmerge_tpu/ops/sa_jax.py, models/build.py, cli/bwt_build.py) on the CPU:
the same numpy inputs, made from a seed, through both; arrays exactly equal,
files byte-identical (tolerance zero: every quantity is an integer).  Only
final results are compared, never a doubling round's intermediate order,
which unstable sorts may break differently.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bwtmerge_tpu.cli import bwt_build as jax_cli  # noqa: E402
from bwtmerge_tpu.models import build as j_build  # noqa: E402
from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.ops import sa_jax  # noqa: E402
from bwtmerge_tpu_torch.cli import bwt_build as port_cli  # noqa: E402
from bwtmerge_tpu_torch.models import build as p_build  # noqa: E402
from bwtmerge_tpu_torch.models.fmi import FMI  # noqa: E402
from bwtmerge_tpu_torch.ops import sa_torch  # noqa: E402

COMP2CHAR = np.frombuffer(b"$ACGTN", np.uint8)


def _same_runs(got, want):
    return (np.array_equal(got.syms, want.syms)
            and np.array_equal(got.lens, want.lens))


# -- suffix array ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 100, 1000, 5000])
def test_suffix_array_random(n):
    text = np.random.default_rng(n).integers(0, 8, n).astype(np.int64)
    got = sa_torch.suffix_array_device(text, "cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, sa_jax.suffix_array_device(text))
    assert np.array_equal(got, oracle.suffix_array(text))


def test_suffix_array_repetitive_text(rng):
    # long equal runs force many doubling rounds
    text = np.repeat(rng.integers(0, 3, 40), 50).astype(np.int64)
    text = np.concatenate([text + 10, [0]])
    got = sa_torch.suffix_array_device(text, "cpu")
    assert np.array_equal(got, sa_jax.suffix_array_device(text))
    assert np.array_equal(got, oracle.suffix_array(text))


def test_suffix_array_equal_characters_and_negative_values():
    # every suffix differs from the next only by its length: the
    # end-of-string rule alone orders them
    text = np.full(300, 7, np.int64)
    assert np.array_equal(sa_torch.suffix_array_device(text, "cpu"),
                          oracle.suffix_array(text))
    text = np.random.default_rng(3).integers(-5, 3, 400).astype(np.int64)
    assert np.array_equal(sa_torch.suffix_array_device(text, "cpu"),
                          sa_jax.suffix_array_device(text))


def test_suffix_array_empty_and_too_large():
    assert sa_torch.suffix_array_device(np.zeros(0, np.int64), "cpu").size == 0

    with pytest.raises(ValueError, match="31-bit"):
        sa_torch.suffix_array_device(np.broadcast_to(np.int8(1), 2**31 - 1),
                                     "cpu")


def test_cuda_device_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    col = [np.array([1, 2, 3], np.int64)]
    with pytest.raises(RuntimeError, match="cuda"):
        sa_torch.suffix_array_device(np.arange(4), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sa_torch.build_bwt_device(col, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sa_torch.rlo_order_device(col, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        p_build.build_from_reads(col, backend="torch", device="cuda")


# -- BWT of a collection --------------------------------------------------------


@pytest.mark.parametrize("n_seqs,min_len,max_len", [
    (1, 1, 1), (3, 1, 8), (60, 20, 60), (40, 1, 200)])
def test_build_bwt_device(rng, n_seqs, min_len, max_len):
    col = oracle.random_collection(rng, n_seqs, min_len, max_len)
    stats = {}
    got = sa_torch.build_bwt_device(col, "cpu", stats)
    assert _same_runs(got, sa_jax.build_bwt_device(col))
    assert _same_runs(got, oracle.build_bwt(col))
    assert stats["positions"] == sum(s.size for s in col) + n_seqs
    assert stats["rounds"] >= 1


def test_build_bwt_device_identical_reads():
    col = [np.array([1, 2, 3, 4], np.int64)] * 17
    got = sa_torch.build_bwt_device(col, "cpu")
    assert _same_runs(got, sa_jax.build_bwt_device(col))
    assert _same_runs(got, oracle.build_bwt(col))


def test_build_bwt_device_rejects_endmarkers_and_takes_empty():
    with pytest.raises(ValueError, match="comp values >= 1"):
        sa_torch.build_bwt_device([np.array([1, 0, 2], np.int64)], "cpu")
    assert sa_torch.build_bwt_device([], "cpu").n_runs == 0
    # reads without characters: only endmarkers
    got = sa_torch.build_bwt_device([np.zeros(0, np.int64)] * 3, "cpu")
    assert _same_runs(got, oracle.build_bwt([np.zeros(0, np.int64)] * 3))


def test_build_bwt_device_packed_tuple(rng):
    col = oracle.random_collection(rng, 20, 5, 40)
    flat = np.concatenate(col).astype(np.int32)
    lengths = np.array([s.size for s in col], np.int64)
    got = sa_torch.build_bwt_device((flat, lengths), "cpu")
    assert _same_runs(got, sa_jax.build_bwt_device((flat, lengths)))
    assert _same_runs(got, oracle.build_bwt(col))


# -- RLO order ------------------------------------------------------------------


@pytest.mark.parametrize("trial", range(5))
def test_rlo_order_device(trial):
    col = oracle.random_collection(np.random.default_rng(40 + trial), 50, 1,
                                   70)
    got = sa_torch.rlo_order_device(col, "cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, sa_jax.rlo_order_device(col))
    assert np.array_equal(got, j_build.rlo_order(col))
    assert np.array_equal(got, p_build.rlo_order(col))


def test_rlo_order_device_suffix_read_sorts_first():
    col = [np.array([2, 1, 3], np.int64),   # reversed: 3 1 2
           np.array([1, 3], np.int64),      # reversed: 3 1   (prefix)
           np.array([3], np.int64)]         # reversed: 3     (prefix)
    assert sa_torch.rlo_order_device(col, "cpu").tolist() == [2, 1, 0]


@pytest.mark.parametrize("lo,hi", [(55, 90), (11, 31), (19, 21)])
def test_rlo_order_device_reads_past_one_key(rng, lo, hi):
    # reads longer than a key's 10 characters: 2 to 9 int32 keys, an odd
    # and an even number of them
    col = oracle.random_collection(rng, 40, lo, hi)
    got = sa_torch.rlo_order_device(col, "cpu")
    assert np.array_equal(got, sa_jax.rlo_order_device(col))
    assert np.array_equal(got, j_build.rlo_order(col))


def test_rlo_order_device_ties_keep_input_order():
    col = [np.array([1, 2], np.int64), np.array([4], np.int64),
           np.array([1, 2], np.int64), np.array([4], np.int64),
           np.array([1, 2], np.int64)]
    got = sa_torch.rlo_order_device(col, "cpu")
    assert got.tolist() == j_build.rlo_order(col).tolist() == [0, 2, 4, 1, 3]


def test_rlo_order_device_empty_and_trivial():
    assert sa_torch.rlo_order_device([], "cpu").size == 0
    assert sa_torch.rlo_order_device([np.zeros(0, np.int64)],
                                     "cpu").tolist() == [0]


# -- host helpers, held array-equal ---------------------------------------------


@pytest.mark.parametrize("fixed", [False, True])
def test_host_helpers(rng, fixed):
    col = (oracle.random_collection(rng, 30, 12, 12) if fixed
           else oracle.random_collection(rng, 30, 1, 45))
    jp, pp = sa_jax.pack_collection(col), sa_torch.pack_collection(col)
    for g, w in zip(pp, jp):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    # a packed tuple passes through
    for g, w in zip(sa_torch.pack_collection(pp), pp):
        assert np.array_equal(g, w)
    empty = sa_torch.pack_collection([])
    assert empty[0].size == 0 and empty[1].size == 0
    jk, pk = sa_jax.rlo_pack_keys(*jp), sa_torch.rlo_pack_keys(*pp)
    assert np.array_equal(pk, jk) and pk.dtype == jk.dtype == np.int32
    order = rng.permutation(len(col))
    for g, w in zip(sa_torch._reorder_packed(*pp, order),
                    sa_jax._reorder_packed(*jp, order)):
        assert np.array_equal(g, w) and g.dtype == w.dtype


# -- build_from_reads -----------------------------------------------------------


@pytest.mark.parametrize("rlo", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "torch", "auto", "sharded"])
def test_build_from_reads_backends(rng, backend, rlo):
    col = oracle.random_collection(rng, 60, 5, 80)
    j_backend = {"torch": "jax"}.get(backend, backend)
    want, want_order = j_build.build_from_reads(col, rlo=rlo,
                                                backend=j_backend)
    got, order = p_build.build_from_reads(col, rlo=rlo, backend=backend,
                                          device="cpu")
    assert np.array_equal(order, want_order)
    assert _same_runs(got, want)
    assert _same_runs(got, oracle.build_bwt([col[i] for i in order]))


def test_build_from_reads_auto_rule_and_unknown_backend(rng, monkeypatch):
    assert p_build._DEVICE_BUILD_MIN_POSITIONS == \
        j_build._DEVICE_BUILD_MIN_POSITIONS == 1 << 20
    use = p_build._use_device_build
    assert use("torch", 1, "cpu") and not use("numpy", 1 << 30, "cuda")
    assert not use("auto", (1 << 20) - 1, "cuda")
    assert use("auto", 1 << 20, "cuda") and use("auto", 1 << 20, "cuda:0")
    assert not use("auto", 1 << 30, "cpu")
    col = oracle.random_collection(rng, 5, 5, 9)
    # 'sharded' spreads the suffix sort over the mesh it is given
    got, order = p_build.build_from_reads(col, rlo=True, backend="sharded",
                                          device="cpu", mesh=["cpu"] * 4)
    want, want_order = j_build.build_from_reads(col, rlo=True,
                                                backend="sharded")
    assert np.array_equal(order, want_order) and _same_runs(got, want)
    with pytest.raises(ValueError, match="backend"):
        p_build.build_from_reads(col, backend="jax", device="cpu")
    # a collection past the threshold under 'auto' goes to the device asked
    # for when that is a CUDA device
    monkeypatch.setattr(p_build, "_DEVICE_BUILD_MIN_POSITIONS", 8)
    seen = []
    import bwtmerge_tpu_torch.ops.sa_torch as mod

    monkeypatch.setattr(mod, "build_bwt_device",
                        lambda packed, device, stats: seen.append(device)
                        or "runs")
    assert p_build.build_from_reads(col, device="cuda")[0] == "runs"
    assert seen == ["cuda"]


def test_rlo_is_query_equivalent_and_rlo_reorder(rng):
    base = rng.integers(1, 5, 30)
    reads = [np.concatenate([rng.integers(1, 5, int(rng.integers(0, 4))),
                             base[int(rng.integers(0, 15)):]])
             for _ in range(30)]
    orig = FMI.from_runs(oracle.build_bwt(reads))
    from bwtmerge_tpu.models.fmi import FMI as JFMI

    want = j_build.rlo_reorder(JFMI.from_runs(oracle.build_bwt(reads)))
    for backend in ("numpy", "torch"):
        got = p_build.rlo_reorder(orig, backend=backend, device="cpu")
        assert _same_runs(got, want)
    rlo = FMI.from_runs(got)
    assert rlo.runs.n_runs <= orig.runs.n_runs
    pats = [rng.integers(1, 5, int(rng.integers(2, 6))) for _ in range(15)]
    assert np.array_equal(orig.verify(pats), rlo.verify(pats))
    a = p_build.alphabet_for(got)
    b = j_build.alphabet_for(want)
    assert np.array_equal(a.C, b.C)


# -- plain reads files ----------------------------------------------------------


@pytest.mark.parametrize("data", [
    b"ACGT\n\nNNA\r\nT\n", b"ACXT\n", b"ACGT\r\n\nGGN\nTT", b"", b"\n\n",
    b"acgtn\nA\n"])
def test_read_plain_reads(tmp_path, data):
    p = tmp_path / "reads.txt"
    p.write_bytes(data)
    want_flat, want_lens = j_build.read_plain_reads_packed(str(p))
    flat, lens = p_build.read_plain_reads_packed(str(p))
    assert np.array_equal(flat, want_flat) and flat.dtype == want_flat.dtype
    assert np.array_equal(lens, want_lens) and lens.dtype == want_lens.dtype
    got = p_build.read_plain_reads(str(p))
    want = j_build.read_plain_reads(str(p))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


@pytest.mark.parametrize("data,line", [
    (b"ACGT\nAC$T\n", 2), (b"\n\nAC\r\n$\n", 4), (b"A\x00C\n", 1)])
def test_read_plain_reads_rejects_endmarker_with_file_and_line(tmp_path, data,
                                                               line):
    p = tmp_path / "reads.txt"
    p.write_bytes(data)
    with pytest.raises(ValueError) as want:
        j_build.read_plain_reads_packed(str(p))
    with pytest.raises(ValueError) as got:
        p_build.read_plain_reads_packed(str(p))
    assert str(got.value) == str(want.value)
    assert f"reads.txt:{line}:" in str(got.value)


# -- the bwt_build CLI ----------------------------------------------------------


def _write_reads(path, reads):
    with open(path, "wb") as f:
        for r in reads:
            f.write(COMP2CHAR[r].tobytes() + b"\n")
    return str(path)


@pytest.mark.parametrize("fmt", ["sga", "native"])
@pytest.mark.parametrize("rlo", [[], ["--rlo"]])
@pytest.mark.parametrize("backend", ["numpy", "torch", "sharded"])
def test_bwt_build_cli_matches_jax(tmp_path, rng, capsys, backend, rlo, fmt):
    reads = oracle.random_collection(rng, 40, 3, 35)
    src = _write_reads(tmp_path / "reads.txt", reads)
    j_out, p_out = str(tmp_path / "j.out"), str(tmp_path / "p.out")
    j_backend = "jax" if backend == "torch" else backend
    assert jax_cli.main([src, j_out, "-o", fmt, "--backend", j_backend,
                         *rlo]) == 0
    j_text = capsys.readouterr().out
    assert port_cli.main([src, p_out, "-o", fmt, "--backend", backend,
                          "--device", "cpu", *rlo]) == 0
    p_text = capsys.readouterr().out
    for suffix in ("", ".reads4"):
        with open(j_out + suffix, "rb") as f1, open(p_out + suffix,
                                                    "rb") as f2:
            assert f1.read() == f2.read(), suffix
    assert "TPU" not in p_text and "BWT build (PyTorch)" in p_text
    # same counts line, up to the rate
    line = [x for x in p_text.splitlines() if " reads, " in x][0]
    assert line.split("(")[0] == [x for x in j_text.splitlines()
                                  if " reads, " in x][0].split("(")[0]


def test_bwt_build_cli_no_sidecar_quiet_and_formats(tmp_path, rng, capsys):
    import os

    reads = oracle.random_collection(rng, 10, 3, 20)
    src = _write_reads(tmp_path / "reads.txt", reads)
    out = str(tmp_path / "o.sga")
    assert port_cli.main([src, out, "-o", "sga", "--no-sidecar", "--quiet",
                          "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    assert os.path.exists(out) and not os.path.exists(out + ".reads4")
    assert port_cli.main(["x", "y", "--list-formats"]) == 0
    p_text = capsys.readouterr().out
    assert jax_cli.main(["x", "y", "--list-formats"]) == 0
    assert p_text == capsys.readouterr().out and "sga" in p_text


@pytest.mark.parametrize("data,needle", [(b"ACG$\n", "bad.txt:1"),
                                         (b"", "no reads")])
def test_bwt_build_cli_bad_input_exits_1_alike(tmp_path, capsys, data,
                                               needle):
    src = tmp_path / "bad.txt"
    src.write_bytes(data)
    out = str(tmp_path / "out.sga")
    assert jax_cli.main([str(src), out, "-o", "sga", "--quiet"]) == 1
    want = capsys.readouterr().err
    assert port_cli.main([str(src), out, "-o", "sga", "--quiet", "--device",
                          "cpu"]) == 1
    got = capsys.readouterr().err
    assert got == want and needle in got


def test_bwt_build_cli_sharded_and_missing_file(tmp_path, capsys):
    src = tmp_path / "r.txt"
    src.write_bytes(b"ACGT\n")
    out = tmp_path / "o.sga"
    # --backend sharded builds (over one CPU entry here) the JAX CLI's bytes
    want = tmp_path / "want.sga"
    assert jax_cli.main([str(src), str(want), "-o", "sga", "--backend",
                         "sharded", "--quiet"]) == 0
    assert port_cli.main([str(src), str(out), "-o", "sga", "--backend",
                          "sharded", "--device", "cpu", "--quiet"]) == 0
    assert out.read_bytes() == want.read_bytes()
    capsys.readouterr()
    assert port_cli.main([str(tmp_path / "nope.txt"), str(out), "--quiet",
                          "--device", "cpu"]) == 1
    assert "bwt_build:" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_cli.main([str(src), str(out), "-o", "nosuchformat"])
