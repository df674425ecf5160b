"""The port's two-input merge (bwtmerge_tpu_torch/models/merge.py) against the
JAX package's merge, on the CPU, by the walk search and, where B comes
without usable read text, by the trie search: the written files must be
byte-identical.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import bwtmerge_tpu_torch as port  # noqa: E402
from bwtmerge_tpu.formats import write_bwt  # noqa: E402
from bwtmerge_tpu.formats.sidecar import (sidecar_path,  # noqa: E402
                                          write_sidecar_reads)
from bwtmerge_tpu.models import fmi as jax_fmi  # noqa: E402
from bwtmerge_tpu.models import merge as jax_merge  # noqa: E402
from bwtmerge_tpu.models import oracle  # noqa: E402
from bwtmerge_tpu.utils.alphabet import Alphabet  # noqa: E402
from jax_native_once import build_jax_native_once  # noqa: E402

build_jax_native_once()


def _write(tmp_path, name, seqs, sidecar):
    path = str(tmp_path / f"{name}.sga")
    write_bwt(path, "sga", oracle.build_bwt(seqs), Alphabet())
    if sidecar:
        write_sidecar_reads(sidecar_path(path), seqs)
    return path


def _inputs(tmp_path, seed, n_a=12, n_b=9):
    r = np.random.default_rng(seed)
    a = oracle.random_collection(r, n_a, 1, 70)
    b = oracle.random_collection(r, n_b, 1, 70)
    return (_write(tmp_path, "a", a, False), _write(tmp_path, "b", b, True),
            a, b)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def walk_env(monkeypatch):
    monkeypatch.setenv("BWTMERGE_SEARCH", "walk")


@pytest.mark.parametrize("fmt", ["sga", "native"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merge_to_file_matches_jax(tmp_path, walk_env, seed, fmt):
    a_path, b_path, a, b = _inputs(tmp_path, seed)
    want = str(tmp_path / f"jax.{fmt}")
    jax_merge.merge_fmi_to_file(
        jax_fmi.load_fmi(a_path, "sga"), jax_fmi.load_fmi(b_path, "sga"),
        want, fmt, jax_merge.MergeConfig(backend="jax",
                                         temp_dir=str(tmp_path)))
    got = str(tmp_path / f"port.{fmt}")
    port.merge_fmi_to_file(port.load_fmi(a_path, "sga"),
                           port.load_fmi(b_path, "sga"), got, fmt,
                           port.MergeConfig(device="cpu",
                                            temp_dir=str(tmp_path)))
    assert _read(got) == _read(want)
    from bwtmerge_tpu.formats import read_bwt

    runs, _, _ = read_bwt(got, fmt)
    assert runs == oracle.merge_collections([a, b])


@pytest.mark.parametrize("blocks", [0, 1, 2, 3])
def test_merge_fmi_serialized_matches_jax(tmp_path, walk_env, blocks):
    a_path, b_path, _, _ = _inputs(tmp_path, 4, n_a=20, n_b=15)
    want = str(tmp_path / "jax.sga")
    merged = jax_merge.merge_fmi(
        jax_fmi.load_fmi(a_path, "sga"), jax_fmi.load_fmi(b_path, "sga"),
        jax_merge.MergeConfig(backend="jax", temp_dir=str(tmp_path)))
    jax_fmi.serialize_fmi(merged, want, "sga")
    got = str(tmp_path / "port.sga")
    config = port.MergeConfig(device="cpu", device_blocks=blocks)
    m = port.merge_fmi(port.load_fmi(a_path, "sga"),
                       port.load_fmi(b_path, "sga"), config)
    port.serialize_fmi(m, got, "sga")
    assert _read(got) == _read(want)
    assert "search (rank array)" in config.timer.phases
    assert m.hash() == merged.hash()


def _jax_merge_to_file(a_path, b_path, want, tmp_path):
    jax_merge.merge_fmi_to_file(
        jax_fmi.load_fmi(a_path, "sga"), jax_fmi.load_fmi(b_path, "sga"),
        want, "sga", jax_merge.MergeConfig(backend="jax",
                                           temp_dir=str(tmp_path)))


def test_merge_without_sidecar_raises(tmp_path):
    # a B without a sidecar raises nothing: under search='auto' it goes
    # through the trie search, in both packages, to the same bytes
    r = np.random.default_rng(5)
    a = oracle.random_collection(r, 5, 1, 30)
    b = oracle.random_collection(r, 5, 1, 30)
    a_path = _write(tmp_path, "a", a, False)
    b_path = _write(tmp_path, "b", b, False)
    want = str(tmp_path / "jax.sga")
    _jax_merge_to_file(a_path, b_path, want, tmp_path)
    merged = port.merge_fmi(port.load_fmi(a_path, "sga"),
                            port.load_fmi(b_path, "sga"),
                            port.MergeConfig(device="cpu"))
    got = str(tmp_path / "port.sga")
    port.serialize_fmi(merged, got, "sga")
    assert _read(got) == _read(want)
    assert merged.runs == oracle.merge_collections([a, b])


def test_merge_with_foreign_sidecar_raises(tmp_path, capsys):
    # the sidecar of another collection fails the consistency gate of both
    # packages; it is ignored with a warning and the trie search merges B
    r = np.random.default_rng(6)
    a_path = _write(tmp_path, "a", oracle.random_collection(r, 5, 1, 30), False)
    b_path = _write(tmp_path, "b", oracle.random_collection(r, 5, 1, 30), False)
    write_sidecar_reads(sidecar_path(b_path),
                        oracle.random_collection(r, 5, 1, 30))
    want = str(tmp_path / "jax.sga")
    _jax_merge_to_file(a_path, b_path, want, tmp_path)
    capsys.readouterr()
    got = str(tmp_path / "o.sga")
    port.merge_fmi_to_file(port.load_fmi(a_path, "sga"),
                           port.load_fmi(b_path, "sga"), got, "sga",
                           port.MergeConfig(device="cpu"))
    assert "ignoring stale reads sidecar" in capsys.readouterr().err
    assert _read(got) == _read(want)


def test_config_refuses_trie_and_missing_cuda(monkeypatch):
    # the trie is a search like the others; an unknown one is refused
    assert port.MergeConfig(device="cpu", search="trie").sanitize()
    with pytest.raises(ValueError, match="auto/walk/trie"):
        port.MergeConfig(device="cpu", search="dfs").sanitize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port.MergeConfig(device="cuda").sanitize()


def test_fmi_device_index_is_cached_and_never_jax(tmp_path):
    a_path, _, _, _ = _inputs(tmp_path, 7)
    f = port.load_fmi(a_path, "sga")
    idx = f.device_index("cpu")
    assert f.device_index("cpu") is idx
    assert not hasattr(f, "_device")      # the port's FMI has no JAX index
    f.invalidate()
    assert f.device_index("cpu") is not idx
