"""The port's bwt_merge CLI (bwtmerge_tpu_torch/cli/bwt_merge.py) against the
JAX package's, on the CPU: same output bytes, same -v counts, same exit
status, on every route (two-input merge, k-way fold, pairwise chain,
--low-memory, --checkpoint resume, --search walk without a sidecar,
--search trie, a B without a sidecar); later-slice features exit with
status 1.
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
    a, b, pats, _, _ = inputs
    out = tmp_path / "o.sga"
    if argv == ["--search", "trie"]:
        # no later slice any more: three inputs under --search trie take the
        # pairwise chain with the trie search, to the JAX CLI's bytes
        res = _both(tmp_path, capsys, [a, b, a], ["-v", pats, *argv],
                    sidecars=False)
        _assert_same(res, 3)
        return
    rc = port_cli.main([a, b, a, str(out), "-i", "sga", "--device", "cpu",
                        "--quiet", *argv])
    assert rc == 1
    assert "ROADMAP" in capsys.readouterr().err
    assert not out.exists()


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
