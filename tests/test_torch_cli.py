"""The port's bwt_merge CLI (bwtmerge_tpu_torch/cli/bwt_merge.py) against the
JAX package's, on the CPU: same output bytes, same -v counts, same exit
status, on every route (two-input merge, k-way fold, pairwise chain,
--low-memory, --checkpoint resume, --search walk without a sidecar,
--search trie, a B without a sidecar, -t N over a mesh of CPU entries,
--index-placement sharded); -t N on fewer GPUs exits with status 1.
"""

import os
import re
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bwtmerge_tpu.cli import bwt_merge as jax_cli  # noqa: E402
from bwtmerge_tpu.formats import write_bwt  # noqa: E402
from bwtmerge_tpu.formats.sidecar import (sidecar_path,  # noqa: E402
                                          write_sidecar_reads)
from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.utils.alphabet import Alphabet  # noqa: E402
from bwtmerge_tpu_torch.cli import bwt_merge as port_cli  # noqa: E402
from test_torch_kfold import within  # noqa: E402


def _write(path, seqs, sidecar_reads=None):
    write_bwt(str(path), "sga", oracle.build_bwt(seqs), Alphabet())
    if sidecar_reads is not None:
        write_sidecar_reads(sidecar_path(str(path)), sidecar_reads)
    return str(path)


def _patterns(path, seqs, rng, n=60):
    comp2char = Alphabet().comp2char
    lines = []
    for k in range(n):
        s = seqs[k % len(seqs)]
        a = int(rng.integers(0, max(1, s.size - 3)))
        p = s[a:a + int(rng.integers(1, 7))] if k % 4 else \
            rng.integers(1, 5, size=5)
        lines.append(bytes(comp2char[np.asarray(p)]).decode())
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def inputs(tmp_path):
    r = np.random.default_rng(21)
    a = oracle.random_collection(r, 14, 2, 60)
    b = oracle.random_collection(r, 11, 2, 60)
    pats = _patterns(tmp_path / "p.txt", a + b, r)
    return (_write(tmp_path / "a.sga", a), _write(tmp_path / "b.sga", b, b),
            pats, a, b)


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out
    counts = re.findall(r"^(Input|Output): (\d+) patterns, (\d+) occurrences",
                        out, re.M)
    return rc, counts, out


@pytest.mark.parametrize("extra", [[], ["--stream"], ["--hash"],
                                   ["--device-blocks", "2"]])
def test_cli_matches_jax(tmp_path, inputs, capsys, extra):
    a, b, pats, _, _ = inputs
    res = {}
    for name, cli, dev in (("jax", jax_cli, []),
                           ("port", port_cli, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.sga")
        args = [a, b, out, "-i", "sga", "-o", "sga", "-v", pats, *dev,
                *[x for x in extra if name == "port"
                  or x not in ("--device-blocks", "2")]]
        rc, counts, text = _run(cli, args, capsys)
        hashes = re.findall(r"^Hash:\s+(\w+)", text, re.M)
        res[name] = (rc, counts, open(out, "rb").read(), hashes)
    assert res["port"] == res["jax"]
    rc, counts, _, hashes = res["port"]
    assert rc == 0 and len(counts) == 3
    assert int(counts[2][2]) == int(counts[0][2]) + int(counts[1][2]) > 0
    assert bool(hashes) == ("--hash" in extra)


def _unsampled_lane(n_reads, max_len):
    """A lane the sidecar gate's LF spot-check does not sample
    (bwtmerge_tpu.models.merge._creads_spotcheck)."""
    rng = np.random.default_rng((n_reads << 16) ^ max_len)
    sampled = set(np.unique(rng.integers(0, n_reads, size=min(8, n_reads))))
    return next(i for i in range(n_reads) if i not in sampled)


def test_corrupted_sidecar_fails_verification_alike(tmp_path, capsys):
    # B's sidecar keeps every read's composition but swaps two characters
    # of one read the gate does not sample: both merges trust it, write the
    # same wrong BWT, and -v catches it with status 2.
    r = np.random.default_rng(22)
    a = oracle.random_collection(r, 10, 20, 40)
    b = oracle.random_collection(r, 30, 20, 40)
    lane = _unsampled_lane(len(b), max(s.size for s in b))
    bad = [s.copy() for s in b]
    s = bad[lane]
    j = int(np.flatnonzero(s != s[0])[0])
    s[0], s[j] = s[j], s[0]
    a_path = _write(tmp_path / "a.sga", a)
    b_path = _write(tmp_path / "b.sga", b, bad)
    comp2char = Alphabet().comp2char
    kmers = {bytes(comp2char[b[lane][i:i + k]]).decode()
             for k in (2, 3, 4, 6) for i in range(b[lane].size - k + 1)}
    pats = tmp_path / "p.txt"
    pats.write_text("\n".join(sorted(kmers)) + "\n")
    res = {}
    for name, cli, dev in (("jax", jax_cli, []),
                           ("port", port_cli, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.sga")
        rc, counts, _ = _run(cli, [a_path, b_path, out, "-i", "sga", "-o",
                                   "sga", "-v", str(pats), *dev], capsys)
        res[name] = (rc, counts, open(out, "rb").read())
    assert res["port"] == res["jax"]
    assert res["port"][0] == 2


@pytest.mark.parametrize("argv", [
    ["-t", "2"], ["--index-placement", "sharded"], ["--search", "trie"]])
def test_later_slice_features_exit_1(tmp_path, inputs, capsys, argv):
    # no later slice any more: three inputs with each of these run to the
    # JAX CLI's bytes (-t 2 over two CPU entries, the fold on one device as
    # in the JAX CLI; a sharded placement of one device is replicated;
    # --search trie takes the pairwise chain with the trie search)
    a, b, pats, _, _ = inputs
    res = _both(tmp_path, capsys, [a, b, a], ["-v", pats, *argv],
                sidecars=False)
    _assert_same(res, 3)


@pytest.mark.parametrize("argv", [
    ["-t", "2"], ["-t", "3", "--search", "trie"],
    ["-t", "2", "--search", "trie", "-s", "2"],
    ["-t", "2", "--search", "trie", "-s", "7"],
    ["-t", "2", "--index-placement", "sharded", "--search", "trie"],
    ["-t", "4", "--index-placement", "sharded", "--search", "trie", "-s",
     "3"],
    ["-t", "2", "--fold", "chain", "--stream"]])
def test_mesh_cli_matches_jax(tmp_path, inputs, capsys, argv):
    # the mesh routes of a pairwise merge (walk lanes dealt over the shards;
    # one sequence block a shard; the dynamic queue; record tables split
    # over the mesh; a chain of two merges) write the JAX CLI's bytes, the
    # JAX CLI on its virtual CPU devices, the port on CPU entries
    a, b, pats, _, _ = inputs
    paths = [a, b, a] if "--fold" in argv else [a, b]
    res = _both(tmp_path, capsys, paths, ["-v", pats, *argv])
    _assert_same(res, len(paths))


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    """Four SGA pieces with read-text sidecars, big enough that a k-way
    fold's rate line has a nonzero second decimal, and patterns."""
    d = tmp_path_factory.mktemp("pieces")
    r = np.random.default_rng(23)
    seqs = [oracle.random_collection(r, 900, 20, 60) for _ in range(4)]
    seqs[3][0] = seqs[0][0].copy()             # a read shared by two pieces
    paths = [_write(d / f"p{k}.sga", s, s) for k, s in enumerate(seqs)]
    pats = _patterns(d / "p.txt", [x for s in seqs for x in s], r, n=200)
    return d, paths, pats


def _copies(tmp_path, name, paths, sidecars=True):
    """The pieces copied into their own directory (a run may write
    sidecars or checkpoints next to them)."""
    d = tmp_path / name
    d.mkdir()
    out = []
    for p in paths:
        shutil.copy(p, d)
        if sidecars and os.path.exists(sidecar_path(p)):
            shutil.copy(sidecar_path(p), d)
        out.append(str(d / os.path.basename(p)))
    return out


def _both(tmp_path, capsys, paths, extra, sidecars=True, out_fmt="sga"):
    """Run both CLIs on their own copies of `paths` (CKPT in `extra` names
    each one's own checkpoint directory): {name: (rc, -v counts, output
    bytes, stdout, stderr, input copies)}."""
    res = {}
    for name, cli, dev in (("jax", jax_cli, []),
                           ("port", port_cli, ["--device", "cpu"])):
        files = _copies(tmp_path, name, paths, sidecars)
        out = str(tmp_path / name / f"out.{out_fmt}")
        args = [str(tmp_path / name / "ckpt") if x == "CKPT" else x
                for x in extra]
        rc = within(300, cli.main, [*files, out, "-i", "sga", "-o", out_fmt,
                                    "-d", str(tmp_path / name), *dev,
                                    *args])
        cap = capsys.readouterr()
        counts = re.findall(r"^(Input|Output): (\d+) patterns, (\d+) "
                            r"occurrences", cap.out, re.M)
        data = open(out, "rb").read() if os.path.exists(out) else None
        res[name] = (rc, counts, data, cap.out, cap.err, files)
    return res


def _assert_same(res, n_inputs, verified=True):
    assert res["port"][:3] == res["jax"][:3]
    rc, counts, data = res["port"][:3]
    assert rc == 0 and data
    if verified:
        assert len(counts) == n_inputs + 1
        assert int(counts[-1][2]) == sum(int(c[2]) for c in counts[:-1]) > 0


@pytest.mark.parametrize("n_inputs", [3, 4])
def test_kway_fold_matches_jax(tmp_path, pieces, capsys, n_inputs):
    _, paths, pats = pieces
    res = _both(tmp_path, capsys, paths[:n_inputs], ["-v", pats],
                sidecars=False)
    _assert_same(res, n_inputs)
    out = res["port"][3]
    rate = re.search(rf"^Merged {n_inputs} inputs in one k-way fold: "
                     r"([0-9.]+) MB/s", out, re.M)
    assert rate and float(rate.group(1)) > 0      # C.4: bases counted
    assert "Verification successful" in out


@pytest.mark.parametrize("extra,n_inputs", [
    (["--fold", "chain"], 3), (["--low-memory"], 4), (["--fold", "kway"], 2),
    (["--fold", "kway", "--stream"], 2), (["--low-memory", "--fold", "kway",
                                           "--checkpoint", "CKPT"], 3)])
def test_pairwise_routes_match_jax(tmp_path, pieces, capsys, extra,
                                   n_inputs):
    _, paths, pats = pieces
    res = _both(tmp_path, capsys, paths[:n_inputs], ["-v", pats, *extra])
    _assert_same(res, n_inputs)
    err = res["port"][4]
    assert ("falling back to the pairwise chain" in err) == \
        ("kway" in extra)
    assert ("--checkpoint ignored" in err) == any("CKPT" in x for x in extra)


def test_kway_to_unstreamable_format_falls_back(tmp_path, pieces, capsys):
    _, paths, _ = pieces
    res = _both(tmp_path, capsys, paths[:3], ["--fold", "kway", "--hash"],
                out_fmt="plain_sorted")
    _assert_same(res, 3, verified=False)
    hashes = [re.findall(r"^Hash:\s+(\w+)", res[k][3], re.M)
              for k in ("jax", "port")]
    assert hashes[0] == hashes[1] and hashes[0]


def test_checkpoint_resume_matches_jax(tmp_path, pieces, capsys):
    # run with --checkpoint, delete the output, run again: the second run
    # resumes from the last checkpoint and writes the same bytes; the port
    # also resumes from the checkpoint the JAX CLI left
    _, paths, pats = pieces
    first = _both(tmp_path, capsys, paths[:3], ["-v", pats, "--checkpoint",
                                                "CKPT"])
    _assert_same(first, 3)
    res = {}
    for name, cli, ckpt_of in (("jax", jax_cli, "jax"),
                               ("port", port_cli, "port"),
                               ("port_on_jax", port_cli, "jax")):
        files = first[ckpt_of][5]
        out = str(tmp_path / ckpt_of / "out.sga")
        os.remove(out)
        dev = [] if cli is jax_cli else ["--device", "cpu"]
        rc = within(300, cli.main, [*files, out, "-i", "sga", "-o", "sga",
                                    "-v", pats, "--checkpoint",
                                    str(tmp_path / ckpt_of / "ckpt"), *dev])
        text = capsys.readouterr().out
        assert "Resuming after 2 merged increment(s)" in text
        res[name] = (rc, open(out, "rb").read(),
                     re.findall(r"^Output: (\d+) patterns, (\d+) occurrences"
                                r"|^(Verification \w+)", text, re.M))
    assert res["port"] == res["jax"] == res["port_on_jax"]
    assert res["port"][0] == 0 and res["port"][1] == first["port"][2]


@pytest.mark.parametrize("extra", [[], ["--low-memory"]])
def test_search_walk_without_sidecar_matches_jax(tmp_path, pieces, capsys,
                                                  extra):
    # B has no sidecar: --search walk decodes its reads on the device and
    # caches them as its sidecar, the reads it was built from; the JAX
    # package caches them on the in-memory route only
    _, paths, pats = pieces
    res = _both(tmp_path, capsys, paths[:2],
                ["-v", pats, "--search", "walk", *extra], sidecars=False)
    _assert_same(res, 2)
    b_port, b_jax = res["port"][5][1], res["jax"][5][1]
    with open(sidecar_path(paths[1]), "rb") as f:
        built = f.read()
    with open(sidecar_path(b_port), "rb") as f:
        assert f.read() == built
    assert os.path.exists(sidecar_path(b_jax)) == (not extra)
    if not extra:
        with open(sidecar_path(b_jax), "rb") as f:
            assert f.read() == built


def test_b_without_sidecar_exits_1(tmp_path, inputs, capsys):
    # a B without a sidecar exits 0: --search auto sends it through the trie
    # search, and the output and the -v counts are the JAX CLI's
    a, _, pats, a_seqs, b_seqs = inputs
    b = _write(tmp_path / "b_plain.sga", b_seqs)
    res = _both(tmp_path, capsys, [a, b], ["-v", pats], sidecars=False)
    _assert_same(res, 2)
    from bwtmerge_tpu.formats import read_bwt

    runs, _, _ = read_bwt(str(tmp_path / "port" / "out.sga"), "sga")
    assert runs == oracle.merge_collections([a_seqs, b_seqs])


def test_too_few_files_and_missing_input(tmp_path):
    assert port_cli.main(["a", "b"]) == 1
    with pytest.raises(FileNotFoundError):
        port_cli.main(["nope.sga", "nope2.sga", str(tmp_path / "o.sga"),
                       "-i", "sga", "--device", "cpu", "--quiet"])


# -- the arguments the port's CLI had refused (-r, -b, -m, -s,
# --hbm-budget-mb, --backend, --profile, --list-formats) ----------------------


def _spill_counter(monkeypatch):
    """Counts the spill files the port's ladder writes."""
    from bwtmerge_tpu_torch.models import spill

    made = []
    real = spill.RankArraySpill._spill

    def counting(self):
        real(self)
        made.append(self._files[-1].path)
        assert os.path.exists(made[-1])

    monkeypatch.setattr(spill.RankArraySpill, "_spill", counting)
    return made


@pytest.mark.parametrize("extra", [
    ["-r", "8"], ["-b", "1"], ["-m", "2"], ["-s", "3"],
    ["--hbm-budget-mb", "100"], ["--backend", "numpy"],
    ["--backend", "numpy", "-s", "1"], ["--backend", "numpy", "--stream"],
    ["--backend", "numpy", "--low-memory"], ["--profile", "PROF"]],
    ids=lambda x: "".join(x))
def test_cli_argument_matches_jax(tmp_path, pieces, capsys, extra):
    _, paths, pats = pieces
    res = {}
    for name, cli, dev in (("jax", jax_cli, []),
                           ("port", port_cli, ["--device", "cpu"])):
        files = _copies(tmp_path, name, paths[:2])
        out = str(tmp_path / name / "out.sga")
        args = [str(tmp_path / name / "prof") if x == "PROF" else x
                for x in extra]
        rc = within(300, cli.main, [*files, out, "-i", "sga", "-o", "sga",
                                    "-v", pats, "-d", str(tmp_path / name),
                                    *dev, *args])
        cap = capsys.readouterr()
        counts = re.findall(r"^(Input|Output): (\d+) patterns, (\d+) "
                            r"occurrences", cap.out, re.M)
        res[name] = (rc, counts, open(out, "rb").read(), cap.out)
    assert res["port"][:3] == res["jax"][:3]
    assert res["port"][0] == 0 and len(res["port"][1]) == 3
    assert ("Backend:          numpy" in res["port"][3]) == ("numpy" in extra)
    if "--profile" in extra:
        traces = os.listdir(tmp_path / "port" / "prof")
        assert len(traces) == 1 and traces[0].endswith(".json")
        assert os.path.getsize(tmp_path / "port" / "prof" / traces[0]) > 100
        import json

        with open(tmp_path / "port" / "prof" / traces[0]) as f:
            assert json.load(f)["traceEvents"]


def test_numpy_backend_spills_under_d_and_matches_default(tmp_path, pieces,
                                                         capsys, monkeypatch):
    # -r counts millions of runs, so -r 1 -m 2 spills only past 2 M runs;
    # -r 0 -m 2 -b 0 spills at every compaction (1024 runs), in both CLIs
    _, paths, pats = pieces
    made = _spill_counter(monkeypatch)
    d = tmp_path / "spill"
    d.mkdir()
    out = str(tmp_path / "numpy.sga")
    rc = port_cli.main([*paths[:2], out, "-i", "sga", "-o", "sga", "-v", pats,
                        "--backend", "numpy", "-r", "0", "-m", "2", "-b", "0",
                        "-s", "9", "-d", str(d), "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and "Verification successful" in text
    assert len(made) >= 2
    assert all(os.path.dirname(p) == str(d) for p in made)
    assert not os.listdir(d)                     # consumed by the stream
    n_spilled = len(made)
    ref = str(tmp_path / "default.sga")
    assert port_cli.main([*paths[:2], ref, "-i", "sga", "-o", "sga",
                          "--device", "cpu", "--quiet"]) == 0
    assert len(made) == n_spilled                # the device route: no ladder
    with open(out, "rb") as f1, open(ref, "rb") as f2:
        assert f1.read() == f2.read()
    # the JAX CLI with the same arguments writes the same bytes
    j_out = str(tmp_path / "jax.sga")
    assert jax_cli.main([*paths[:2], j_out, "-i", "sga", "-o", "sga",
                         "--backend", "numpy", "-r", "0", "-m", "2", "-b",
                         "0", "-s", "9", "-d", str(d), "--quiet"]) == 0
    with open(out, "rb") as f1, open(j_out, "rb") as f2:
        assert f1.read() == f2.read()


def test_merge_config_ladder_fields_follow_the_jax_package():
    from bwtmerge_tpu.models.merge import MergeConfig as JConfig
    from bwtmerge_tpu_torch.models.merge import MergeConfig as PConfig

    j, p = JConfig(), PConfig(device="cpu")
    for name in ("run_buffer_runs", "thread_buffer_mb", "merge_buffers",
                 "sequence_blocks", "hbm_budget_bytes", "interleave"):
        assert getattr(p, name) == getattr(j, name), name
    j = JConfig(merge_buffers=0, sequence_blocks=-3).sanitize()
    p = PConfig(device="cpu", merge_buffers=0, sequence_blocks=-3).sanitize()
    assert (p.merge_buffers, p.sequence_blocks) == \
        (j.merge_buffers, j.sequence_blocks) == (1, 1)


def test_list_formats_matches_jax(capsys):
    assert jax_cli.main(["--list-formats", "x"]) == 0
    want = capsys.readouterr().out
    assert port_cli.main(["--list-formats", "x"]) == 0
    got = capsys.readouterr().out
    assert got == want and "native" in got and "sga" in got


def test_every_jax_cli_argument_parses_in_the_port():
    # every option string of the JAX CLI's parser is one of the port's
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    missing = options(jax_cli.build_parser()) - options(
        port_cli.build_parser())
    assert not missing, missing
    args = port_cli.build_parser().parse_args(
        ["-r", "8", "-b", "2", "-m", "3", "-s", "5", "--hbm-budget-mb", "7",
         "--backend", "numpy", "--profile", "d", "--list-formats", "a", "b",
         "o"])
    assert (args.run_buffer, args.thread_buffer, args.merge_buffers,
            args.sequence_blocks, args.hbm_budget_mb, args.backend,
            args.profile, args.list_formats) == (8, 2, 3, 5, 7, "numpy", "d",
                                                 True)


def test_later_slice_message_names_the_item_only(tmp_path, inputs, capsys,
                                                 monkeypatch):
    # -t 2 --device cuda on a machine of one GPU: status 1, and the message
    # names the GPUs torch sees (the mesh never quietly shrinks)
    import torch

    a, b, _, _, _ = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "o.sga"
    assert port_cli.main([a, b, str(out), "-i", "sga", "-t", "2",
                          "--device", "cuda", "--quiet"]) == 1
    err = capsys.readouterr().err
    assert "torch.cuda.device_count() is 1" in err and "slice" not in err
    assert not out.exists()


def test_numpy_backend_with_three_inputs_takes_the_chain(tmp_path, pieces,
                                                        capsys):
    _, paths, pats = pieces
    res = _both(tmp_path, capsys, paths[:3], ["-v", pats, "--backend",
                                              "numpy"])
    _assert_same(res, 3)
    assert "k-way fold" not in res["port"][3]


# -- bwt_convert and bwt_inspect ------------------------------------------------


def test_convert_every_format_pair_matches_jax(tmp_path, inputs):
    from bwtmerge_tpu.cli import bwt_convert as j_convert
    from bwtmerge_tpu_torch.cli import bwt_convert as p_convert

    a = inputs[0]
    prev = {"jax": (a, "sga"), "port": (a, "sga")}
    for fmt in ("ropebwt", "plain_default", "plain_sorted", "rfm", "sdsl",
                "native", "sga"):
        data = {}
        for name, cli in (("jax", j_convert), ("port", p_convert)):
            src, src_fmt = prev[name]
            dst = str(tmp_path / f"{name}.{fmt}")
            assert cli.main([src, dst, "-i", src_fmt, "-o", fmt,
                             "--quiet"]) == 0
            prev[name] = (dst, fmt)
            with open(dst, "rb") as f:
                data[name] = f.read()
        assert data["port"] == data["jax"], fmt
    with open(a, "rb") as f:
        assert f.read() == data["port"]          # the chain came back to it


def test_convert_defaults_banner_and_bad_format(tmp_path, inputs, capsys):
    from bwtmerge_tpu.cli import bwt_convert as j_convert
    from bwtmerge_tpu_torch.cli import bwt_convert as p_convert

    a = inputs[0]
    outs = {}
    for name, cli in (("jax", j_convert), ("port", p_convert)):
        dst = str(tmp_path / f"{name}.native")
        assert cli.main([a, dst]) == 0           # sga -> native by default
        outs[name] = (open(dst, "rb").read(),
                      capsys.readouterr().out.splitlines())
    assert outs["port"][0] == outs["jax"][0]
    p_lines, j_lines = outs["port"][1], outs["jax"][1]
    assert p_lines[0] == "BWT converter (PyTorch)" and "TPU" in j_lines[0]
    assert [x for x in p_lines[1:] if "converted in" not in x
            and "Memory" not in x and "port.native" not in x] == \
        [x for x in j_lines[1:] if "converted in" not in x
         and "Memory" not in x and "jax.native" not in x]
    with pytest.raises(SystemExit):
        p_convert.main([a, str(tmp_path / "x"), "-i", "bogus"])
    assert p_convert.main(["--list-formats", "a", "b"]) == 0
    got = capsys.readouterr().out
    assert j_convert.main(["--list-formats", "a", "b"]) == 0
    assert got == capsys.readouterr().out


def test_convert_rlo_matches_jax(tmp_path, capsys):
    from bwtmerge_tpu.cli import bwt_convert as j_convert
    from bwtmerge_tpu.models.build import alphabet_for, build_from_reads
    from bwtmerge_tpu_torch.cli import bwt_convert as p_convert

    rng = np.random.default_rng(31)
    reads = [rng.integers(1, 4, 10) for _ in range(10)]
    runs = oracle.build_bwt(reads)
    src = str(tmp_path / "in.sga")
    write_bwt(src, "sga", runs, alphabet_for(runs))
    data = {}
    for name, cli, dev in (("jax", j_convert, []),
                           ("port", p_convert, ["--device", "cpu"])):
        dst = str(tmp_path / f"{name}.native")
        assert cli.main([src, dst, "-i", "sga", "-o", "native", "--rlo",
                         *dev]) == 0
        text = capsys.readouterr().out
        data[name] = (open(dst, "rb").read(),
                      re.findall(r"^RLO reorder: .*$", text, re.M))
    assert data["port"] == data["jax"] and data["port"][1]
    from bwtmerge_tpu.formats import read_bwt

    got, _, _ = read_bwt(str(tmp_path / "port.native"), "native")
    assert got == build_from_reads(reads, rlo=True)[0]


def test_inspect_matches_jax(tmp_path, inputs, capsys):
    from bwtmerge_tpu.cli import bwt_inspect as j_inspect
    from bwtmerge_tpu_torch.cli import bwt_convert as p_convert
    from bwtmerge_tpu_torch.cli import bwt_inspect as p_inspect

    a, b, _, a_seqs, b_seqs = inputs
    native = str(tmp_path / "a.native")
    rope = str(tmp_path / "a.ropebwt")
    p_convert.main([a, native, "--quiet"])
    p_convert.main([a, rope, "-o", "ropebwt", "--quiet"])
    junk = str(tmp_path / "junk.bin")
    with open(junk, "wb") as f:
        f.write(b"\x00" * 64)
    files = [native, a, b, rope, junk, str(tmp_path / "missing")]
    assert j_inspect.main(files) == 0
    want = capsys.readouterr()
    assert p_inspect.main(files) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert "Native format" in got.out and "Unknown format" in got.out
    assert f"Total: {2 * len(a_seqs) + len(b_seqs)} sequences" in got.out
    assert "Cannot open input file" in got.err
    with open(native, "rb") as f:
        head = f.read(64)
    assert p_inspect.identify(head)[1:] == j_inspect.identify(head)[1:]
