"""The port's multi-process merge (bwtmerge_tpu_torch/parallel/distributed.py)
in a world of two processes on gloo, against the JAX package's
single-process merge.

The test starts this same file twice as a script (the worker below), each
a rank of a torch.distributed world formed over localhost, each searching
its block of B's sequences on a mesh of two CPU entries.  The rank array is
exchanged by A-position range (one all_to_all), each process interleaves
its range and encodes its fragment of the output, and process 0
concatenates the fragments.  The combined rank array and the merged SGA
and native files must equal the JAX package's single-process results byte
for byte.  The workers run under the import hook of test_torch_nojax.py,
which refuses jax and bwtmerge_tpu: this file imports JAX only inside the
test function.

Worker: python tests/test_torch_multihost.py <rank> <port> <out_dir>
"""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED, A_SHAPE, B_SHAPE = 55, (24, 20, 60), (22, 20, 60)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(pid: int, port: str, out_dir: str) -> None:
    sys.path.insert(0, ROOT)
    from bwtmerge_tpu_torch.models import oracle
    from bwtmerge_tpu_torch.models.fmi import FMI
    from bwtmerge_tpu_torch.parallel.distributed import (
        exchange_by_rank_range, initialize_multihost, multihost_merge_to_file,
        multihost_rank_array, multihost_rank_array_ranged, process_info)
    from bwtmerge_tpu_torch.parallel.mesh import make_mesh

    initialize_multihost(f"tcp://127.0.0.1:{port}", 2, pid, timeout_s=120)
    assert process_info() == (pid, 2)
    mesh = make_mesh(2, "cpu")                  # this process's own mesh
    rng = np.random.default_rng(SEED)
    fa = FMI.from_runs(oracle.build_bwt(oracle.random_collection(rng,
                                                                 *A_SHAPE)))
    fb = FMI.from_runs(oracle.build_bwt(oracle.random_collection(rng,
                                                                 *B_SHAPE)))

    # --- ranged exchange: each process holds ONLY its own A-range ---------
    stats = {}
    my_v, my_c, b_off, lo, hi, drain, ovf = multihost_rank_array_ranged(
        fa.device_index("cpu"), fb.device_index("cpu"), fa.sequences(),
        fb.sequences(), mesh=mesh, stats=stats)
    assert not ovf
    # peak contract: the largest routed piece and the runs received are
    # O(|RA|/P); |RA| <= |B| runs, so 2x the balanced share plus slack
    bound = 2 * (fb.size() // 2) + 64
    assert stats["exchange_width"] <= bound, stats
    assert stats["recv_runs"] <= bound, stats
    assert np.all(np.diff(my_v) > 0)
    assert (my_v >= lo).all() and (my_v < int(hi)).all()

    # --- fully distributed merged output, fragments in rank order --------
    mstats, nstats = {}, {}
    multihost_merge_to_file(fa, fb, os.path.join(out_dir, "merged.sga"),
                            "sga", shard_dir=out_dir, device="cpu",
                            mesh=mesh, stats=mstats)
    total_out = os.path.getsize(os.path.join(out_dir, "merged.sga"))
    assert 0 < mstats["frag_bytes"] < total_out, mstats
    assert mstats["shard_runs"] <= bound, mstats
    multihost_merge_to_file(fa, fb, os.path.join(out_dir, "merged.native"),
                            "native", shard_dir=out_dir, device="cpu",
                            mesh=mesh, stats=nstats)
    assert 0 < nstats["frag_bytes"], nstats

    # --- count skew: the splitters balance POSITION mass, not runs --------
    n_light, n_heavy = 20_000, 64
    light_v = np.linspace(1 << 20, 1 << 40, n_light).astype(np.int64)
    heavy_v = np.arange(n_heavy, dtype=np.int64) * 97 + 3
    v_all = np.concatenate([heavy_v, light_v])
    c_all = np.concatenate([np.full(n_heavy, 1_000_000, np.int64),
                            np.ones(n_light, np.int64)])
    o = np.argsort(v_all)
    v_all, c_all = v_all[o], c_all[o]
    _, my_c2, _ = exchange_by_rank_range(np.ascontiguousarray(v_all[pid::2]),
                                         np.ascontiguousarray(c_all[pid::2]))
    from bwtmerge_tpu_torch.parallel.distributed import _allgather_i64
    masses = _allgather_i64(np.asarray([int(my_c2.sum())])).reshape(-1)
    assert int(masses.sum()) == int(c_all.sum()), masses
    assert int(masses.max()) <= int(c_all.sum()), masses

    # --- the whole rank array, assembled from the range shards ------------
    v, c, ovf = multihost_rank_array(fa.device_index("cpu"),
                                     fb.device_index("cpu"), fa.sequences(),
                                     fb.sequences(), mesh=mesh)
    assert not ovf
    if pid == 0:
        np.savez(os.path.join(out_dir, "combined.npz"), values=v, counts=c,
                 range_runs=my_v.size, masses=masses,
                 total_mass=int(c_all.sum()))
    # leave the world together: a gloo group still alive at interpreter
    # exit can abort the process in its teardown
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def test_two_process_merge_matches_jax(tmp_path):
    from test_torch_nojax import HOOK

    from bwtmerge_tpu.models import oracle
    from bwtmerge_tpu.models.fmi import FMI
    from bwtmerge_tpu.models.merge import MergeConfig, merge_fmi_to_file
    from bwtmerge_tpu.ops import search_np

    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(HOOK)
    out = tmp_path / "out"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(hook), ROOT])
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), port, str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    got = np.load(out / "combined.npz")
    rng = np.random.default_rng(SEED)
    fa = FMI.from_runs(oracle.build_bwt(oracle.random_collection(rng,
                                                                 *A_SHAPE)))
    fb = FMI.from_runs(oracle.build_bwt(oracle.random_collection(rng,
                                                                 *B_SHAPE)))
    want_v, want_c = search_np.build_rank_array(
        fa.rank_index, fa.alpha.C.astype(np.int64),
        fb.rank_index, fb.alpha.C.astype(np.int64),
        fa.sequences(), fb.sequences())
    assert np.array_equal(got["values"], want_v)
    assert np.array_equal(got["counts"], want_c)
    # the exchange stayed range-bounded: process 0 held a strict subset
    assert 0 < int(got["range_runs"]) < want_v.size
    # the count-weighted splitters kept each process within 2x of balance
    assert int(got["masses"].max()) <= int(got["total_mass"])
    for fmt in ("sga", "native"):
        want = tmp_path / f"single.{fmt}"
        merge_fmi_to_file(fa, fb, str(want), fmt, MergeConfig(backend="numpy"))
        assert (out / f"merged.{fmt}").read_bytes() == want.read_bytes(), fmt
    assert not [f for f in os.listdir(out) if f.startswith(".bwtmerge_frag")]


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
