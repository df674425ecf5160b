"""The port is a package of its own: it imports torch, never jax, and
nothing of the JAX package bwtmerge_tpu.

The first case runs in a subprocess because tests/conftest.py imports jax
into this one.  The child, and every process it starts (the fold's
subprocess stages), runs under a sitecustomize that makes an import of
`jax`, `jax.*`, `bwtmerge_tpu` or `bwtmerge_tpu.*` raise.  There the
fixtures are made with the port's own formats and oracle, every port module,
chip_smoke and the two-process test's worker (tests/test_torch_multihost.py,
whose workers run under the same hook) are imported, and the port's CLI runs
a two-input merge by the walk and by the trie search, the merge over meshes
of CPU entries (-t 2, the dynamic queue, --index-placement sharded), a
three-input k-way fold with its subprocess chain and a merge on the numpy
backend with --profile, the bwt_build (numpy, torch and sharded),
bwt_convert and bwt_inspect CLIs run, the device interleave and the
range-parallel host interleave merge a pair, and the xlarge bench
(bwtmerge_tpu_torch/xlarge/) builds its fixtures and big pieces and folds
its 3-way and big-piece tiers at a small scale, so that a lazy import on
any of these paths fails too.
The second case reads the port's sources for such an import.
"""

import os
import pkgutil
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOOK = textwrap.dedent("""
    import sys


    class _Refuse:
        names = ("jax", "bwtmerge_tpu")

        def find_spec(self, fullname, path=None, target=None):
            if fullname.split(".")[0] in self.names:
                raise ImportError(f"the port must not import {fullname}")
            return None


    sys.meta_path.insert(0, _Refuse())
""")

CHILD = textwrap.dedent("""
    import importlib
    import pkgutil
    import sys

    assert any(type(f).__name__ == "_Refuse" for f in sys.meta_path)
    for name in ("jax", "bwtmerge_tpu", "bwtmerge_tpu.formats", "jax.numpy"):
        try:
            importlib.import_module(name)
        except ImportError:
            pass
        else:
            raise AssertionError(f"{name} imported under the hook")

    import numpy as np
    import bwtmerge_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        bwtmerge_tpu_torch.__path__, "bwtmerge_tpu_torch.")]
    assert len(names) > 43, names
    for new in ("cli.bwt_build", "cli.bwt_convert", "cli.bwt_inspect",
                "ops.sa_torch", "ops.interleave_torch", "models.build",
                "models.parallel_merge", "parallel.distributed",
                "parallel.mesh", "parallel.sort_distributed",
                "ops.rank_sharded", "xlarge.bench", "xlarge.fixtures",
                "xlarge.big_pieces"):
        assert f"bwtmerge_tpu_torch.{new}" in names, new
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    # the two-process test's worker is its own file, run as a script
    sys.path.insert(0, "tests")
    import test_torch_multihost
    assert callable(test_torch_multihost.worker)
    import bwtmerge_tpu_torch.cli.bwt_merge as cli
    from bwtmerge_tpu_torch.formats import read_bwt, write_bwt
    from bwtmerge_tpu_torch.formats.sidecar import (sidecar_path,
                                                    write_sidecar_reads)
    from bwtmerge_tpu_torch.models import oracle
    from bwtmerge_tpu_torch.utils.alphabet import Alphabet

    d = sys.argv[1]
    r = np.random.default_rng(1)
    colls = []
    for name in "abc":
        seqs = oracle.random_collection(r, 6, 5, 30)
        colls.append(seqs)
        path = f"{d}/{name}.sga"
        write_bwt(path, "sga", oracle.build_bwt(seqs), Alphabet())
        write_sidecar_reads(sidecar_path(path), seqs)
    with open(f"{d}/p.txt", "w") as f:
        f.write("ACG\\nTTA\\n")
    common = ["-i", "sga", "-o", "sga", "-v", f"{d}/p.txt", "--device", "cpu",
              "--quiet"]
    for search in ("walk", "trie"):
        rc = cli.main([f"{d}/a.sga", f"{d}/b.sga", f"{d}/o_{search}.sga",
                       "--search", search, *common])
        assert rc == 0, (search, rc)
        runs, _, _ = read_bwt(f"{d}/o_{search}.sga", "sga")
        assert runs == oracle.merge_collections(colls[:2]), search
    # the mesh routes: -t 2 over two CPU entries (the walk), the trie with
    # the dynamic queue, the record tables split over the mesh
    for extra in (["-t", "2"], ["-t", "2", "--search", "trie", "-s", "5"],
                  ["-t", "3", "--search", "trie", "--index-placement",
                   "sharded"]):
        rc = cli.main([f"{d}/a.sga", f"{d}/b.sga", f"{d}/o_mesh.sga",
                       *extra, *common])
        assert rc == 0, (extra, rc)
        runs, _, _ = read_bwt(f"{d}/o_mesh.sga", "sga")
        assert runs == oracle.merge_collections(colls[:2]), extra
    # three inputs: the k-way fold, its interleave passes as subprocess
    # stages (python -m bwtmerge_tpu_torch.models.kfold_stage), which
    # inherit the hook through PYTHONPATH
    rc = cli.main([f"{d}/{n}.sga" for n in "abc"] + [f"{d}/k.sga", *common])
    assert rc == 0, rc
    runs, _, _ = read_bwt(f"{d}/k.sga", "sga")
    assert runs == oracle.merge_collections(colls)
    # the host search into the spill ladder, with a trace of the merge
    rc = cli.main([f"{d}/a.sga", f"{d}/b.sga", f"{d}/o_numpy.sga",
                   "--backend", "numpy", "-r", "0", "-b", "0", "-d", d,
                   "--profile", f"{d}/prof", *common])
    assert rc == 0, rc
    runs, _, _ = read_bwt(f"{d}/o_numpy.sga", "sga")
    assert runs == oracle.merge_collections(colls[:2])
    # construction, conversion and inspection through their CLIs
    import bwtmerge_tpu_torch.cli.bwt_build as build_cli
    import bwtmerge_tpu_torch.cli.bwt_convert as convert_cli
    import bwtmerge_tpu_torch.cli.bwt_inspect as inspect_cli
    comp2char = Alphabet().comp2char
    with open(f"{d}/reads.txt", "wb") as f:
        for s in colls[0]:
            f.write(bytes(comp2char[s]) + b"\\n")
    for backend in ("numpy", "torch", "sharded"):
        rc = build_cli.main([f"{d}/reads.txt", f"{d}/built_{backend}.sga",
                             "-o", "sga", "--backend", backend, "--device",
                             "cpu", "--quiet"])
        assert rc == 0, (backend, rc)
        runs, _, _ = read_bwt(f"{d}/built_{backend}.sga", "sga")
        assert runs == oracle.build_bwt(colls[0]), backend
    rc = convert_cli.main([f"{d}/a.sga", f"{d}/a_rlo.native", "--rlo",
                           "--device", "cpu", "--quiet"])
    assert rc == 0, rc
    assert inspect_cli.main([f"{d}/a.sga", f"{d}/a_rlo.native"]) == 0
    # the device interleave and the range-parallel host interleave
    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.native import interleave_streaming
    fa = port.load_fmi(f"{d}/a.sga", "sga")
    fb = port.load_fmi(f"{d}/b.sga", "sga")
    merged = port.merge_fmi(fa, fb, port.MergeConfig(
        device="cpu", interleave="device", temp_dir=d))
    assert merged.runs == oracle.merge_collections(colls[:2])
    from bwtmerge_tpu_torch.ops.search_np import build_rank_array
    rv, rc_ = build_rank_array(
        fa.rank_index, fa.alpha.C.astype(np.int64),
        fb.rank_index, fb.alpha.C.astype(np.int64),
        fa.sequences(), fb.sequences())
    parts = list(port.coalesce_run_chunks(
        port.interleave_stream_chunks_parallel(
            fa.runs, fb.runs, iter([(rv[:9], rc_[:9]), (rv[9:], rc_[9:])]),
            workers=2)))
    assert type(fa.runs)(np.concatenate([p[0] for p in parts]),
                         np.concatenate([p[1] for p in parts])) == merged.runs
    # the xlarge tier at 300 reads a piece: fixtures, a big piece, the
    # 3-way and big-piece folds with their checks
    from bwtmerge_tpu_torch.xlarge import bench as xl_bench
    for tier in (["--pieces", "2"], ["--big", "1"]):
        rc = xl_bench.main(tier + ["--reads", "300", "--base-folds", "1",
                                   "--device", "cpu", "--cache", f"{d}/xl"])
        assert rc == 0, (tier, rc)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "bwtmerge_tpu"))
    assert not bad, bad
    print("NOJAX-OK", len(names))
""")


def test_port_never_imports_jax(tmp_path):
    hook_dir = tmp_path / "hook"
    hook_dir.mkdir()
    (hook_dir / "sitecustomize.py").write_text(HOOK)
    work = tmp_path / "work"
    work.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(hook_dir), ROOT])
    r = subprocess.run([sys.executable, "-c", CHILD, str(work)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    # the hook does stop a stage that imports the JAX package
    bad = subprocess.run(
        [sys.executable, "-c", "import bwtmerge_tpu.models.kfold_stage"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert bad.returncode != 0 and "must not import" in bad.stderr


IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:bwtmerge_tpu|jax)(?=[.\s,]|$)", re.M)
SPAWN = re.compile(r"""["']bwtmerge_tpu\.[\w.]+["']""")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "bwtmerge_tpu_torch")):
        out += [os.path.join(base, f) for f in files
                if f.endswith((".py", ".cpp", ".cu", ".h"))]
    return out


def test_port_sources_name_no_import_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 54
    import bwtmerge_tpu_torch

    modules = [m.name for m in pkgutil.walk_packages(
        bwtmerge_tpu_torch.__path__, "bwtmerge_tpu_torch.")]
    assert len([s for s in sources if s.endswith(".py")]) >= len(modules)
    hits = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        for rx in (IMPORT, SPAWN):
            hits += [(os.path.relpath(path, ROOT), m.group(0).strip())
                     for m in rx.finditer(text)]
    assert not hits, hits
    # the patterns do catch what they are for
    for line in ("import bwtmerge_tpu", "from bwtmerge_tpu import x",
                 "    from bwtmerge_tpu.formats import read_bwt",
                 "import jax", "from jax import numpy",
                 "import bwtmerge_tpu.native as n"):
        assert IMPORT.search(line), line
    for line in ("import bwtmerge_tpu_torch", "from bwtmerge_tpu_torch.ops "
                 "import x", "import jaxtyping"):
        assert not IMPORT.search(line), line
    assert SPAWN.search('"-m", "bwtmerge_tpu.models.kfold_stage"')
    assert not SPAWN.search('"bwtmerge_tpu_torch.models.kfold_stage"')
