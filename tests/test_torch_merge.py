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


def _old_creads_consistent(creads, b):
    """The sidecar's gate as it was before the native byte count and the
    one-pass index: composition by np.bincount of a uint8 copy, then the
    spot check with an index built by numpy passes (the JAX package's
    SparseRankIndex.build, equal to the port's former eight passes)."""
    from bwtmerge_tpu.ops.rank_np import SparseRankIndex

    if creads.shape[1] != b.sequences():
        return False
    have = np.bincount(creads.reshape(-1).astype(np.uint8),
                       minlength=8).astype(np.int64)
    C = b.alpha.C.astype(np.int64)
    if not np.array_equal(have[1:6], np.diff(C[:7])[1:]):
        return False
    r = creads.shape[1]
    if r == 0:
        return True
    rank = SparseRankIndex.build(b.runs, b.alpha.sigma)
    rng = np.random.default_rng((r << 16) ^ creads.shape[0])
    lanes = np.unique(rng.integers(0, r, size=min(8, r)))
    pos = lanes.astype(np.int64)
    for t in range(creads.shape[0]):
        rnk, sym = rank.inverse_select(pos)
        if not np.array_equal(sym.astype(np.int64),
                              creads[t, lanes].astype(np.int64)):
            return False
        pos = np.where(sym != 0, C[sym.astype(np.int64)] + rnk, pos)
        if not (sym != 0).any():
            break
    return True


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("seed", [1, 2])
def test_gate_rejects_a_changed_read_as_the_old_gate(tmp_path, seed, dtype):
    """Each read of B's sidecar changed in turn, once with two of its
    characters swapped (the composition stays right) and once with one
    character replaced (it does not): the port's gate accepts or rejects
    each exactly as the old gate and the JAX package's gate do.  int32
    stands for an array attached from elsewhere than the layout."""
    from bwtmerge_tpu.formats.sidecar import creads_layout

    from bwtmerge_tpu_torch.models.merge import _creads_consistent

    r = np.random.default_rng(seed)
    seqs = oracle.random_collection(r, 24, 8, 30)
    b_path = _write(tmp_path, "b", seqs, True)
    pb, jb = port.load_fmi(b_path, "sga"), jax_fmi.load_fmi(b_path, "sga")
    creads = creads_layout(np.array([s.size for s in seqs], np.uint32),
                           np.concatenate(seqs).astype(np.uint8)).astype(dtype)
    assert _creads_consistent(creads, pb) and _old_creads_consistent(
        creads, pb)
    seen = set()
    for lane, s in enumerate(seqs):
        i, j = 0, int(np.flatnonzero(s != s[0])[0])     # two distinct chars
        t_i, t_j = s.size - 1 - i, s.size - 1 - j        # rows from the end
        swapped, replaced = creads.copy(), creads.copy()
        swapped[[t_i, t_j], lane] = creads[[t_j, t_i], lane]
        replaced[t_i, lane] = s[j]
        for changed in (swapped, replaced):
            got = _creads_consistent(changed, pb)
            assert got == _old_creads_consistent(changed, pb)
            assert got == jax_merge._creads_consistent(changed, jb)
            seen.add((changed is swapped, got))
    # some swapped reads are sampled and rejected, some not; every
    # replaced character fails the composition
    assert seen == {(True, True), (True, False), (False, False)}
