"""The port imports torch and never jax.

Runs in a subprocess because tests/conftest.py imports jax into this one.
There `import jax` is made to fail, every port module and chip_smoke are
imported, and a small two-input merge and a three-input k-way fold run
through the port's CLI on the CPU, so that a lazy import on either path
would fail too.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import sys
    for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
        del sys.modules[name]
    sys.modules["jax"] = None           # any `import jax` now raises
    sys.path.insert(0, {root!r})

    import numpy as np
    import bwtmerge_tpu_torch
    import bwtmerge_tpu_torch.cli.bwt_merge as cli
    import bwtmerge_tpu_torch.cli.common
    import bwtmerge_tpu_torch.convert
    import bwtmerge_tpu_torch.kernels
    import bwtmerge_tpu_torch.models.kfold
    import bwtmerge_tpu_torch.models.merge
    import bwtmerge_tpu_torch.ops.decode_torch
    import bwtmerge_tpu_torch.ops.kfold_torch
    import bwtmerge_tpu_torch.ops.ra_stream
    import bwtmerge_tpu_torch.ops.rank_streamed
    import bwtmerge_tpu_torch.ops.walk_torch
    import chip_smoke
    from bwtmerge_tpu.formats import write_bwt
    from bwtmerge_tpu.formats.sidecar import sidecar_path, write_sidecar_reads
    from bwtmerge_tpu.models import oracle
    from bwtmerge_tpu.utils.alphabet import Alphabet

    d = sys.argv[1]
    r = np.random.default_rng(1)
    for name in "abc":
        seqs = oracle.random_collection(r, 6, 5, 30)
        path = f"{{d}}/{{name}}.sga"
        write_bwt(path, "sga", oracle.build_bwt(seqs), Alphabet())
        write_sidecar_reads(sidecar_path(path), seqs)
    with open(f"{{d}}/p.txt", "w") as f:
        f.write("ACG\\nTTA\\n")
    rc = cli.main([f"{{d}}/a.sga", f"{{d}}/b.sga", f"{{d}}/o.sga", "-i", "sga",
                   "-o", "sga", "-v", f"{{d}}/p.txt", "--device", "cpu",
                   "--quiet"])
    assert rc == 0, rc
    rc = cli.main([f"{{d}}/{{n}}.sga" for n in "abc"] + [
        f"{{d}}/k.sga", "-i", "sga", "-o", "sga", "-v", f"{{d}}/p.txt",
        "--device", "cpu", "--quiet"])
    assert rc == 0, rc
    assert sys.modules["jax"] is None
    print("NOJAX-OK")
""").format(root=ROOT)


def test_port_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
