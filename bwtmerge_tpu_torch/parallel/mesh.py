"""Multi-device execution: sequence-block data parallelism over a mesh of
torch devices.

Port of bwtmerge_tpu/parallel/mesh.py.  A mesh is a list of torch.devices,
one entry a shard; entries may repeat a device, so several shards can share
one card (the counterpart of the JAX tests' virtual CPU devices).  The
mapping of the reference's thread-level parallelism (ParallelLoop,
utils.h:254-302; sequence blocks, fmi.cpp:351-357):

  threads            -> mesh entries: one worker thread each, on the entry's
                        device and, on CUDA, a stream of its own, so shards
                        on distinct cards run at once and shards on one card
                        overlap as streams
  sequence blocks    -> contiguous ranges of B's sequence ranks, one per
                        shard (each B suffix has exactly one rank in A, so
                        the shards need no communication)
  the merge ladder   -> every shard's sorted-unique pairs land in one
                        ops/ra_stream.BlockedRA, whose stream() k-way merges
                        them on the host (shard_map's all-gather); a psum
                        becomes a sum on the first mesh entry

The FM-indexes and the walk's planes are replicated: built or copied once
per distinct device of the mesh, not once per entry.  Unlike the JAX
package's programs, nothing here has a static frontier or emission
capacity, so no shard overflows and no route returns None for overflow.
A shard that raises fails the whole call: the first exception is raised
once every worker has stopped.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..kernels import resolve_device
from ..ops.ra_stream import BlockedRA
from ..ops.rank_torch import DeviceFMIndex, count_encoded
from ..ops.search_torch import search_block_runs
from ..ops.walk_torch import build_walk_planes, walk_runs
from ..utils.ranges import get_bounds

SEQ_AXIS = "seq"


def make_mesh(n_devices: Optional[int] = None, device="cuda"
              ) -> List[torch.device]:
    """A 1-D mesh: cuda:0 .. cuda:n-1 (default: every visible GPU), or, for
    device='cpu', n CPU entries (default 1).  Raises when fewer GPUs are
    visible than asked for: the mesh never quietly shrinks."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * max(1, n_devices or 1)
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n < 1 or n > visible:
        raise RuntimeError(
            f"a mesh of {n} CUDA devices was asked for; "
            f"torch.cuda.device_count() is {visible}")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_devices(mesh=None) -> List[torch.device]:
    """The mesh as a list of torch.devices (None: make_mesh()); a CUDA entry
    without an index takes the current device's."""
    if mesh is None:
        mesh = make_mesh()
    out = []
    for entry in mesh:
        dev = resolve_device(entry)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("empty mesh")
    return out


def replicate(idx: DeviceFMIndex, devices) -> Dict[torch.device,
                                                   DeviceFMIndex]:
    """idx on every distinct device of `devices`, copied once a device."""
    out: Dict[torch.device, DeviceFMIndex] = {}
    for dev in devices:
        if dev not in out:
            out[dev] = idx if idx.device == dev else DeviceFMIndex(
                rec=idx.rec.to(dev), C=idx.C.to(dev), size=idx.size,
                n_runs=idx.n_runs)
    return out


def run_shards(devices: List[torch.device],
               fn: Callable[[int, torch.device], object]) -> list:
    """fn(shard, device) on one worker thread per mesh entry; results in
    mesh order.  On CUDA a worker runs under its device and a stream of its
    own, which first waits for what the calling thread queued on that
    device and is synchronised before the worker ends.  The first exception
    of any worker raises here, once all have stopped."""
    waits = {dev: torch.cuda.current_stream(dev) for dev in set(devices)
             if dev.type == "cuda"}
    results: list = [None] * len(devices)
    errors: list = []

    def worker(i: int) -> None:
        dev = devices[i]
        try:
            if dev.type != "cuda":
                results[i] = fn(i, dev)
                return
            with torch.cuda.device(dev):
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(waits[dev])
                with torch.cuda.stream(stream):
                    results[i] = fn(i, dev)
                stream.synchronize()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def sequence_shards(n_sequences: int, n_shards: int) -> np.ndarray:
    """Closed [sp, ep] ranges of B's sequence ranks, one row per shard.

    Mirrors getBounds (utils.cpp:169-187): remainder spread over the first
    shards; empty shards get ep < sp.
    """
    bounds = np.zeros((n_shards, 2), dtype=np.int32)
    base, rem = divmod(n_sequences, n_shards)
    start = 0
    for i in range(n_shards):
        count = base + (1 if i < rem else 0)
        bounds[i] = (start, start + count - 1)
        start += count
    return bounds


def sequence_shards_weighted(weights, n_shards: int) -> np.ndarray:
    """Closed [sp, ep] sequence-rank ranges balanced by WEIGHT (e.g. read
    lengths / bases): shard boundaries at equal quantiles of the cumulative
    weight, so a skewed length distribution no longer idles the shards that
    drew the short reads.  The reference gets the same effect dynamically
    (atomic block counter, utils.cpp:204-209); a static mesh needs the
    balance baked into the partition.  Empty shards get ep < sp.
    """
    w = np.asarray(weights, dtype=np.float64)
    n = w.size
    bounds = np.zeros((n_shards, 2), dtype=np.int32)
    if n == 0:
        bounds[:, 1] = -1
        return bounds
    cum = np.cumsum(w)
    total = cum[-1]
    # boundary i = first sequence whose cumulative weight exceeds the i-th
    # quantile; searchsorted keeps the ranges contiguous and monotone
    qs = total * (np.arange(1, n_shards, dtype=np.float64) / n_shards)
    cuts = np.concatenate(([0], np.searchsorted(cum, qs, side="left") + 1,
                           [n]))
    cuts = np.minimum(cuts, n)
    for i in range(n_shards):
        bounds[i] = (cuts[i], cuts[i + 1] - 1)
    return bounds


def dynamic_block_search(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                         a_sequences: int, b_sequences: int, emit,
                         n_blocks: Optional[int] = None, mesh=None,
                         weights=None, streamed: Optional[bool] = None,
                         stats: Optional[dict] = None) -> None:
    """Host-side dynamic block queue over the mesh: the analog of the
    reference's atomic-counter scheduler (ParallelLoop, utils.cpp:204-209),
    with mesh entries in place of threads.

    B's sequences split into `n_blocks` (default 4 per mesh entry, the
    reference's default) equal-count blocks, or equal-weight blocks when
    per-sequence `weights` are given; one worker per mesh entry pulls blocks
    from a shared queue and searches each on its device
    (search_torch.search_block_runs), so entries that drew cheap blocks pull
    more.  `emit(values, counts)` is called under a lock with each block's
    sorted-unique host runs.  `stats`, when given, receives per_device_runs,
    per_block_runs and n_blocks.  A worker's exception stops the queue and
    raises here.
    """
    devices = mesh_devices(mesh)
    n_dev = len(devices)
    if n_blocks is None:
        n_blocks = 4 * n_dev
    n_blocks = max(1, min(n_blocks, max(1, b_sequences)))
    if weights is not None:
        blocks = [tuple(int(x) for x in b) for b in
                  sequence_shards_weighted(weights, n_blocks) if b[1] >= b[0]]
    else:
        blocks = [b for b in get_bounds((0, b_sequences - 1), n_blocks)
                  if b[1] >= b[0]]

    q: "queue_mod.Queue" = queue_mod.Queue()
    for k, blk in enumerate(blocks):
        q.put((k, blk))
    a_rep, b_rep = replicate(a_idx, devices), replicate(b_idx, devices)
    lock = threading.Lock()
    failed = threading.Event()
    per_device = [0] * n_dev
    per_block = [0] * len(blocks)

    def worker(d: int, dev: torch.device) -> None:
        while not failed.is_set():
            try:
                k, rng = q.get_nowait()
            except queue_mod.Empty:
                return
            try:
                v, c = search_block_runs(a_rep[dev], b_rep[dev], rng,
                                         a_sequences, streamed)
                v, c = v.cpu().numpy(), c.cpu().numpy()
                with lock:
                    per_device[d] += v.size
                    per_block[k] = v.size
                    emit(v, c)
            except BaseException:
                failed.set()
                raise

    run_shards(devices, worker)
    if stats is not None:
        stats["per_device_runs"] = per_device
        stats["per_block_runs"] = per_block
        stats["n_blocks"] = len(blocks)


def sharded_packed_ra(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                      a_sequences: int, b_sequences: int, mesh=None,
                      b_seq_offset: int = 0,
                      streamed: Optional[bool] = None,
                      ra: Optional[BlockedRA] = None,
                      stats: Optional[dict] = None) -> BlockedRA:
    """Mesh-parallel rank array by the trie search: shard d searches the
    sequence ranks sequence_shards(b_sequences, n)[d] + b_seq_offset on its
    device (streamed through kernel K1 on CUDA), and its sorted-unique
    pairs go into `ra` (a BlockedRA that holds every block when None),
    whose stream() feeds the merge phase.  The JAX function returns None
    when a shard overflows its static buffers; this one has none, so it
    never does.  `stats`, when given, receives per_device_runs."""
    devices = mesh_devices(mesh)
    ra = BlockedRA() if ra is None else ra
    bounds = (sequence_shards(b_sequences, len(devices)).astype(np.int64)
              + int(b_seq_offset))
    a_rep, b_rep = replicate(a_idx, devices), replicate(b_idx, devices)

    def shard(d: int, dev: torch.device) -> int:
        sp, ep = int(bounds[d, 0]), int(bounds[d, 1])
        if ep < sp:
            return 0
        values, counts = search_block_runs(a_rep[dev], b_rep[dev], (sp, ep),
                                           a_sequences, streamed)
        ra.add(values, counts)
        return int(values.shape[0])

    runs = run_shards(devices, shard)
    if stats is not None:
        stats["per_device_runs"] = runs
    return ra


def sharded_rank_array(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                       a_sequences: int, b_sequences: int, mesh=None,
                       b_seq_offset: int = 0,
                       streamed: Optional[bool] = None):
    """Rank array of B vs A computed data-parallel over the mesh, as host
    arrays: (values int64[T], counts int64[T], overflowed=False).

    b_seq_offset shifts the searched sequence ranks: a process of a
    multi-process merge passes its own block's start so the mesh shards
    cover [offset, offset + b_sequences - 1] (distributed.py)."""
    v, c = sharded_packed_ra(a_idx, b_idx, a_sequences, b_sequences, mesh,
                             b_seq_offset, streamed).finish()
    return v, c, False


def sharded_backward_search(index: DeviceFMIndex, patterns, lengths,
                            mesh=None) -> np.ndarray:
    """Pattern verification sharded across the mesh (the reference's
    parallel queryFMI, bwt_merge.cpp:240-260): the encoded patterns
    (int[Q, max_len], the first lengths[q] of row q read) split into
    contiguous row blocks, one a shard, each counted through
    rank_torch.count_encoded on its device (the streamed search, kernel K1
    on CUDA, once a shard holds 2^14 patterns).  Counts int64[Q] in pattern
    order."""
    devices = mesh_devices(mesh)
    patterns = np.asarray(patterns)
    lengths = np.asarray(lengths)
    bounds = sequence_shards(patterns.shape[0], len(devices))
    replicas = replicate(index, devices)

    def shard(d: int, dev: torch.device) -> np.ndarray:
        sp, ep = int(bounds[d, 0]), int(bounds[d, 1]) + 1
        return count_encoded(replicas[dev], patterns[sp:ep], lengths[sp:ep])

    return np.concatenate(run_shards(devices, shard))


def sharded_walk_packed_ra(a_idx: DeviceFMIndex, creads: np.ndarray,
                           mesh=None, a_sequences: Optional[int] = None,
                           ra: Optional[BlockedRA] = None,
                           stats: Optional[dict] = None) -> BlockedRA:
    """Mesh-parallel WALK search: B's read lanes (creads int8[max_len, R],
    host) dealt over the shards, A's walk planes replicated.

    Walk lanes are whole reads, so the shards are independent: shard d
    walks its lanes through the planes of its device
    (walk_torch.walk_runs, kernel K2 on CUDA; the planes built by
    walk_planes_build once a distinct device), with its lane count as its
    root share, and its sorted-unique pairs go into `ra` (a BlockedRA that
    holds every block when None).  Reference counterpart: the
    sequence-block data parallelism the walk replaces, fmi.cpp:351-357.
    `stats`, when given, receives per_device_lanes and per_device_runs.
    """
    devices = mesh_devices(mesh)
    n_dev = len(devices)
    ra = BlockedRA() if ra is None else ra
    if a_sequences is None:
        a_sequences = int(a_idx.C[1])
    r_total = creads.shape[1]
    # Char-weighted lane assignment: every lane's walk work is its read
    # length, so equal-LANE shards skew per-device emissions whenever long
    # reads cluster.  Lanes need NOT be contiguous per device (each
    # device's emissions are sorted independently and k-way merged), so a
    # snake deal over the length-sorted lanes balances even adversarial
    # chunky mixes; contiguous quantile cuts cannot (a single long read is
    # an indivisible work unit at a shard boundary).
    weights = (creads > 0).sum(axis=0).astype(np.int64)
    order = np.argsort(-weights, kind="stable")
    slot = np.arange(r_total, dtype=np.int64)
    phase = (slot // n_dev) % 2
    dev_of = np.where(phase == 0, slot % n_dev,
                      n_dev - 1 - (slot % n_dev))
    lanes_of = [order[dev_of == d] for d in range(n_dev)]
    replicas = replicate(a_idx, devices)
    planes = {dev: build_walk_planes(idx.rec) for dev, idx in replicas.items()}

    def shard(d: int, dev: torch.device) -> int:
        lanes = lanes_of[d]
        if not lanes.size:
            return 0
        cr = torch.from_numpy(np.ascontiguousarray(creads[:, lanes])).to(dev)
        values, counts = walk_runs(planes[dev], replicas[dev].C, cr,
                                   a_sequences, int(lanes.size))
        ra.add(values, counts)
        return int(values.shape[0])

    runs = run_shards(devices, shard)
    if stats is not None:
        stats["per_device_lanes"] = [int(g.size) for g in lanes_of]
        stats["per_device_runs"] = runs
    return ra
