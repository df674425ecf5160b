"""The port's bwt_merge CLI (bwtmerge_tpu_torch/cli/bwt_merge.py) against the
JAX package's, on the CPU: same output bytes, same -v counts, same exit
status; later-slice features exit with status 1.
"""

import re

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
    ["EXTRA_INPUT"], ["--fold", "kway"], ["--checkpoint", "ckpt"],
    ["--low-memory"], ["-t", "2"], ["--index-placement", "sharded"],
    ["--search", "trie"]])
def test_later_slice_features_exit_1(tmp_path, inputs, capsys, argv):
    a, b, _, _, _ = inputs
    files = [a, b, a] if argv == ["EXTRA_INPUT"] else [a, b]
    flags = [] if argv == ["EXTRA_INPUT"] else argv
    out = tmp_path / "o.sga"
    rc = port_cli.main([*files, str(out), "-i", "sga", "--device", "cpu",
                        "--quiet", *flags])
    assert rc == 1
    assert "ROADMAP" in capsys.readouterr().err
    assert not out.exists()


def test_b_without_sidecar_exits_1(tmp_path, inputs, capsys):
    a, _, _, _, b_seqs = inputs
    b = _write(tmp_path / "b_plain.sga", b_seqs)
    rc = port_cli.main([a, b, str(tmp_path / "o.sga"), "-i", "sga",
                        "--device", "cpu", "--quiet"])
    assert rc == 1
    assert "sidecar" in capsys.readouterr().err


def test_too_few_files_and_missing_input(tmp_path):
    assert port_cli.main(["a", "b"]) == 1
    with pytest.raises(FileNotFoundError):
        port_cli.main(["nope.sga", "nope2.sga", str(tmp_path / "o.sga"),
                       "-i", "sga", "--device", "cpu", "--quiet"])
