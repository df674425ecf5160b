"""Two-input merge on one torch device: FMI(A) + FMI(B) -> FMI(A ∪ B).

Port of bwtmerge_tpu/models/merge.py (merge_fmi, merge_fmi_to_file,
merge_files, _try_walk_search, _build_ra_spill and _interleave).  The search
phase builds the rank array on the device and streams it to the host block
by block (ops/ra_stream.py) into the native interleave and the format
writers.  backend='numpy' searches on the host instead (ops/search_np.py,
in sequence blocks) and emits into the spill ladder (models/spill.py) that
run_buffer_runs, thread_buffer_mb and merge_buffers size.  interleave=
'device' opts merge_fmi into the device interleave
(ops/interleave_torch.py) for rank arrays that were not spilled.

Two searches build it.  The walk (ops/walk_torch.py) runs every read of B
backward through A's index; it needs B's read text: its `.reads4` sidecar,
gated by a consistency check, or, with search='walk', B's reads decoded on
the device from its own BWT (ops/decode_torch.py), optionally cached as a
sidecar.  The trie search (ops/search_torch.py) needs no read text and
takes every B.  search='auto' walks when a consistent sidecar is on hand
and searches the trie otherwise; 'walk' falls to the trie only where the
walk cannot take B (no reads, or a read of WALK_MAX_LEN or more
characters); 'trie' never looks at a sidecar.  A search that fails on the
device raises: no route falls back to another after an exception.

On a mesh of more than one entry (MergeConfig.devices: a count, or a list
of torch devices that may repeat one) the search takes the JAX package's
multi-device routes in its order (parallel/mesh.py, ops/rank_sharded.py):
the walk with B's lanes dealt over the shards; else, with the index
placement 'sharded', both record tables split over the mesh, searched
block by block into the spill ladder; else, with more sequence blocks than
entries, the dynamic block queue into the ladder; else one sequence block
a shard.  The pairs that device routes hold in host memory are bounded by
run_buffer_runs * merge_buffers runs; past that, blocks drain into the
ladder's spill files under temp_dir (ops/ra_stream.BlockedRA).
"""

from __future__ import annotations

import itertools
import os
import sys
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

from ..kernels import resolve_device
from ..ops.walk_torch import WALK_BLOCK_EMITS, WALK_MAX_LEN
from ..utils.metrics import PhaseTimer
from .fmi import FMI

AUTO_BLOCKS_MIN_BASES = 16 * 1024 * 1024   # two blocks from here up


@dataclass
class MergeConfig:
    """Merge parameters of the port.

    device:        torch device of the search ('cuda' or 'cpu'); 'cuda'
                   without CUDA raises
    backend:       'torch' (search on `device`) or 'numpy' (the host search
                   in sequence_blocks blocks, into the spill ladder)
    interleave:    'native' (the host C++ interleave) or 'device'
                   (ops/interleave_torch.py, both inputs decoded on the
                   device; merge_fmi only, and never for a spilled ladder)
    run_buffer_runs, merge_buffers: the ladder spills to a file under
                   temp_dir once it holds their product of runs (-r, -m)
    thread_buffer_mb: emitted runs compacted every so many megabytes, 16 B
                   a run (-b)
    sequence_blocks: blocks of B's sequences the numpy backend searches
                   one after the other (-s); on a mesh, more blocks than
                   entries take the dynamic block queue
    devices:       the search's mesh (-t): a count (make_mesh(devices,
                   device): cuda:0 .. cuda:n-1, or n CPU entries), or a list
                   of torch devices, which may repeat a device
    index_placement: on more than one entry, 'replicated' (every entry
                   holds the whole index), 'sharded' (record tables split
                   over the mesh, ops/rank_sharded.py) or 'auto' (sharded
                   when the two tables exceed hbm_budget_bytes)
    hbm_budget_bytes: per-device memory budget of the 'auto' placement
                   (0 = DEVICE_MEMORY_SHARE of the smallest device's
                   memory); one entry always holds the whole index
    temp_dir:      scratch directory (-d): spill files of the rank array
                   and of the k-way fold, the chain's intermediate folds
    device_blocks: blocks of B's reads searched one after the other, so
                   block k's rank-array copy overlaps block k+1's search
                   (0 = auto: 2 once B holds 16 Mbp)
    search:        'auto' (the walk over B's read-text sidecar, the trie
                   without one), 'walk' (decodes B's reads on the device
                   when it has no usable sidecar) or 'trie'
    streamed:      the trie search's steps: True probes through the streamed
                   kernel, False gathers one record per query; None takes
                   the device's default (streamed on CUDA, gathers on the CPU)
    cache_sidecar: write a device-decoded B's reads as its sidecar, so that
                   later merges skip the decode (only for B read from a file)
    """

    device: str = "cuda"
    backend: str = "torch"
    interleave: str = "native"
    run_buffer_runs: int = 8 * 1024 * 1024
    thread_buffer_mb: int = 256
    merge_buffers: int = 6
    sequence_blocks: int = 4
    devices: Union[int, Sequence] = 1
    index_placement: str = "auto"
    hbm_budget_bytes: int = 0
    temp_dir: str = "."
    device_blocks: int = 0
    search: str = "auto"
    streamed: Optional[bool] = None
    cache_sidecar: bool = False
    verbose: bool = False
    timer: PhaseTimer = field(default_factory=PhaseTimer)

    def sanitize(self) -> "MergeConfig":
        self.sequence_blocks = max(1, self.sequence_blocks)
        self.merge_buffers = max(1, self.merge_buffers)
        self.device_blocks = max(0, self.device_blocks)
        if self.search not in ("auto", "walk", "trie"):
            raise ValueError(
                f"search must be auto/walk/trie, got {self.search!r}")
        if self.backend not in ("torch", "numpy"):
            raise ValueError(
                f"backend must be torch/numpy, got {self.backend!r}")
        if self.interleave not in ("native", "device"):
            raise ValueError(
                f"interleave must be native/device, got {self.interleave!r}")
        if self.index_placement not in ("auto", "replicated", "sharded"):
            raise ValueError(
                f"index_placement must be auto/replicated/sharded, "
                f"got {self.index_placement!r}")
        if isinstance(self.devices, (list, tuple)):
            if not self.devices:
                raise ValueError("devices: empty mesh")
        else:
            self.devices = max(1, int(self.devices))
        if self.backend == "torch" or self.interleave == "device":
            resolve_device(self.device)
            self.mesh()
        return self

    def mesh(self) -> list:
        """The search's mesh: [device] for devices=1, make_mesh(devices,
        device) for a larger count, the list itself otherwise."""
        from ..parallel.mesh import make_mesh, mesh_devices

        if isinstance(self.devices, (list, tuple)):
            return mesh_devices(self.devices)
        if self.devices == 1:
            return [resolve_device(self.device)]
        return make_mesh(self.devices, self.device)


def _merged_alpha(a: FMI, b: FMI):
    return type(a.alpha)(
        char2comp=a.alpha.char2comp.copy(),
        comp2char=a.alpha.comp2char.copy(),
        C=(a.alpha.C.astype(np.int64)
           + b.alpha.C.astype(np.int64)).astype(np.uint64))


def merge_fmi(a: FMI, b: FMI, config: Optional[MergeConfig] = None) -> FMI:
    """Merge two FMIs into a new one; the inputs are left intact."""
    from ..native import interleave_streaming

    config = (config or MergeConfig()).sanitize()
    if a.alpha != b.alpha:
        raise ValueError("cannot merge BWTs with different alphabets")
    config.timer.verbose = config.verbose

    with config.timer.phase("search (rank array)"):
        ra = _build_ra(a, b, config)

    with config.timer.phase("merge (interleave)"):
        # a spilled ladder must stream; a rank array on the device prefers
        # to (its copy to the host overlaps the native interleave), unless
        # the caller opted into the device interleave
        if ra.n_spill_files or (getattr(ra, "prefer_stream", False)
                                and config.interleave == "native"):
            # capacity hint: every A/B run appears at most once plus at most
            # two seam splits per RA run
            ra_runs = int(getattr(ra, "n_runs", 0) or 0)
            hint = (a.runs.n_runs + b.runs.n_runs + 2 * ra_runs + 16
                    if ra_runs else 0)
            merged_runs = interleave_streaming(a.runs, b.runs, ra.stream(),
                                               hint_runs=hint)
        else:
            ra_values, ra_counts = ra.finish()
            merged_runs = _interleave(a.runs, b.runs, ra_values, ra_counts,
                                      config)

    with config.timer.phase("index build"):
        result = FMI(runs=merged_runs, alpha=_merged_alpha(a, b))

    if config.verbose:
        config.timer.report(b.size())
    return result


def merge_fmi_to_file(a: FMI, b: FMI, path: str, fmt: str = "native",
                      config: Optional[MergeConfig] = None) -> None:
    """Fully streaming merge: A + B -> serialized BWT file, the merged
    sequence never materialized (streaming output formats only)."""
    from ..formats.streaming import write_bwt_stream
    from ..native import interleave_stream_chunks
    from ..utils.pipeline import prefetch_chunks

    config = (config or MergeConfig()).sanitize()
    if a.alpha != b.alpha:
        raise ValueError("cannot merge BWTs with different alphabets")
    config.timer.verbose = config.verbose

    with config.timer.phase("search (rank array)"):
        ra = _build_ra(a, b, config)

    with config.timer.phase("merge (interleave+write)"):
        ra_stream = prefetch_chunks(ra.stream(), depth=2)
        chunks = interleave_stream_chunks(a.runs, b.runs, ra_stream)
        write_bwt_stream(path, fmt, prefetch_chunks(chunks, depth=1),
                         _merged_alpha(a, b))

    if config.verbose:
        config.timer.report(b.size())


def merge_files(a_path: str, b_path: str, out_path: str,
                in_fmt: str = "native", out_fmt: str = "native",
                config: Optional[MergeConfig] = None,
                window_positions: int = 1 << 24,
                stats: Optional[dict] = None,
                in_fmt_b: Optional[str] = None) -> None:
    """Destructive-profile merge: two BWT files -> one merged BWT file
    (streaming output formats only).

    The inputs are released before the merge phase, which re-reads both
    files in bounded run-chunk windows (native/windowed.py) and streams the
    merged runs into the format writer, so the merge phase never holds the
    inputs and the output together (the reference's clearUntil profile).
    The search takes the routes of merge_fmi; B's sidecar is looked for
    next to b_path, and a device decode under search='walk' is cached there
    with cache_sidecar.  (The JAX package's merge_files never looks for a
    sidecar and always searches the trie.)  `stats` receives a_bases,
    b_bases and the windowed interleave's peak window."""
    from ..formats.sidecar import sidecar_path
    from ..formats.streaming import write_bwt_stream
    from ..formats.streaming_read import read_bwt_chunks, read_bwt_streaming
    from ..native.windowed import interleave_windowed_chunks

    config = (config or MergeConfig()).sanitize()
    config.timer.verbose = config.verbose
    in_fmt_b = in_fmt_b or in_fmt
    with config.timer.phase("input read"):
        runs_a, _, alpha_a = read_bwt_streaming(a_path, in_fmt)
        runs_b, _, alpha_b = read_bwt_streaming(b_path, in_fmt_b)
        if alpha_a != alpha_b:
            raise ValueError("cannot merge BWTs with different alphabets")
        a = FMI(runs=runs_a, alpha=alpha_a)
        b = FMI(runs=runs_b, alpha=alpha_b, creads_path=sidecar_path(b_path))
        del runs_a, runs_b

    with config.timer.phase("search (rank array)"):
        ra = _build_ra(a, b, config)

    alpha = _merged_alpha(a, b)
    b_size = b.size()
    if stats is not None:
        stats["a_bases"] = a.size()
        stats["b_bases"] = b_size
    # the rank array is on the device or in flight to pinned host memory;
    # the merge phase below re-reads the files in bounded windows
    del a, b

    with config.timer.phase("merge (windowed interleave+write)"):
        chunks = interleave_windowed_chunks(
            read_bwt_chunks(a_path, in_fmt), read_bwt_chunks(b_path, in_fmt_b),
            ra.stream(), window_positions=window_positions, stats=stats)
        write_bwt_stream(out_path, out_fmt, chunks, alpha)

    if config.verbose:
        config.timer.report(b_size)


class _PrimedStream:
    """A chunk stream whose first chunk was pulled eagerly, with the
    consumption surface the merges read (stream, finish, prefer_stream,
    n_spill_files, total_spilled_bytes, n_runs)."""

    prefer_stream = True
    n_spill_files = 0
    total_spilled_bytes = 0

    def __init__(self, first, rest, n_runs=0):
        self._first = first
        self._rest = rest
        self.n_runs = int(n_runs)    # capacity hint for interleave_streaming

    def stream(self, chunk_runs=None):
        if self._first is None:
            return iter(())
        return itertools.chain([self._first], self._rest)

    def finish(self):
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


def _prime_stream(ra) -> _PrimedStream:
    """Start a blocked rank array's merged stream and pull its first chunk:
    the first block's device-to-host copy has finished, so a fault of the
    search on the device raises here, before any output byte exists."""
    stream = ra.stream()
    return _PrimedStream(next(stream, None), stream, ra.n_runs)


def _creads_consistent(creads, b: FMI) -> bool:
    """Integrity gate before trusting a sidecar.  Two layers:

    1. composition: read count and per-character totals must match B's
       alphabet (catches stale or foreign sidecars cheaply);
    2. content: an LF spot-walk of sampled reads from their endmarker rows
       (extract_sequence semantics, bwt.h:134-164): the decoded characters
       must equal the sidecar columns, so a sidecar of the right
       composition but the wrong content or order (reads from another
       shuffle of the same base pool) is rejected and cannot corrupt the
       merge.

    The sidecar file itself carries an FNV-1a hash checked at load time
    (formats/sidecar.py), which guards torn writes."""
    from ..native import byte_counts

    if creads.shape[1] != b.sequences():
        return False
    flat = creads.reshape(-1)
    if flat.dtype.itemsize != 1:
        flat = flat.astype(np.uint8)
    have = byte_counts(flat)       # of the values as uint8, no int64 copy
    C = b.alpha.C.astype(np.int64)
    want = np.diff(C[:7])          # counts of comps 0..5
    if not np.array_equal(have[1:6], want[1:]):
        return False
    return _creads_spotcheck(creads, b)


def _creads_spotcheck(creads, b: FMI, k: int = 8) -> bool:
    """Decode `k` deterministically sampled reads straight from B's BWT (a
    batched LF walk from their endmarker rows) and compare them with the
    sidecar's columns.

    Uses B's full host rank index when it already exists; otherwise builds
    a block-sampled SparseRankIndex (O(R/stride) memory: the full occ table
    is far too large to build for a spot-check of a large B)."""
    r = creads.shape[1]
    if r == 0:
        return True
    if b._rank is not None and b._rank.size == b.runs.size():
        rank = b._rank
    else:
        from ..ops.rank_np import SparseRankIndex

        rank = SparseRankIndex.build(b.runs, b.alpha.sigma)
    C = b.alpha.C.astype(np.int64)
    rng = np.random.default_rng((r << 16) ^ creads.shape[0])
    lanes = np.unique(rng.integers(0, r, size=min(k, r)))
    pos = lanes.astype(np.int64)
    for t in range(creads.shape[0]):
        rnk, sym = rank.inverse_select(pos)
        if not np.array_equal(sym.astype(np.int64),
                              creads[t, lanes].astype(np.int64)):
            return False
        lf = C[sym.astype(np.int64)] + rnk
        pos = np.where(sym != 0, lf, pos)   # finished lanes park (yield 0)
        if not (sym != 0).any():
            break
    return True


def _write_decoded_sidecar(path: str, creads) -> None:
    """Persist a device-decoded creads array as a sidecar file (lengths and
    flat text recovered from the walk layout)."""
    from ..formats.sidecar import write_sidecar

    lens = (creads > 0).sum(axis=0).astype(np.uint32)
    # flat chars in read order, text order (reverse of the walk layout)
    parts = [creads[:n, i][::-1].astype(np.uint8)
             for i, n in enumerate(lens)]
    flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    write_sidecar(path, lens, flat)


def walk_creads(b: FMI, config: MergeConfig,
                device=None) -> Optional[np.ndarray]:
    """B's read text in walk layout, or None where the merge searches the
    trie: search='trie'; B holds no reads; under 'auto', B has no sidecar
    that passes the consistency gate; under 'walk', the device decode (on
    `device`, default config.device) meets a read of WALK_MAX_LEN or more
    characters."""
    from ..ops.decode_torch import decode_creads

    if config.search == "trie" or b.sequences() == 0:
        return None
    creads = b.creads()
    if creads is not None and not _creads_consistent(creads, b):
        print("ignoring stale reads sidecar (character counts do not match "
              "the BWT)", file=sys.stderr)
        creads = None
        b.creads_path = None
    if creads is None:
        if config.search != "walk":
            return None
        creads = decode_creads(b.device_index(device or config.device),
                               b.sequences(), b.size(),
                               max_len_cap=WALK_MAX_LEN)
        if creads is None:
            return None
        b.attach_creads(creads)
        if config.cache_sidecar and b.creads_path:
            _write_decoded_sidecar(b.creads_path, creads)
    if creads.shape[0] > WALK_MAX_LEN:
        return None
    return creads


def _n_blocks(config: MergeConfig, b: FMI, units: int,
              emits_per_unit: int) -> int:
    """Blocks of B's `units` reads: config.device_blocks (0 = two once B
    holds AUTO_BLOCKS_MIN_BASES), doubled until a block's emissions, at most
    emits_per_unit per read, fit the device budget WALK_BLOCK_EMITS."""
    n_blk = config.device_blocks
    if n_blk == 0:
        n_blk = 2 if b.size() >= AUTO_BLOCKS_MIN_BASES else 1
    while emits_per_unit * -(-units // n_blk) > WALK_BLOCK_EMITS \
            and n_blk < units:
        n_blk *= 2
    return n_blk


def _new_spill(config: MergeConfig):
    """The spill ladder the flags size: compact_every ~ thread buffer (-b,
    16 B a run), spill threshold ~ the merge buffers' total (-r * -m),
    files under temp_dir (-d); the reference's buffer hierarchy,
    fmi.h:49-51."""
    from .spill import RankArraySpill

    compact_every = config.thread_buffer_mb * 1024 * 1024 // 16  # 16 B/run
    return RankArraySpill(
        temp_dir=config.temp_dir,
        spill_threshold_runs=config.run_buffer_runs * config.merge_buffers,
        compact_every=max(compact_every, 1024))


def _blocked_ra(config: MergeConfig):
    """The device routes' rank array: blocks held while their runs stay
    within run_buffer_runs * merge_buffers (-r, -m), the rest drained into
    the spill ladder (ops/ra_stream.BlockedRA)."""
    from ..ops.ra_stream import BlockedRA

    return BlockedRA(config.run_buffer_runs * config.merge_buffers,
                     lambda: _new_spill(config))


def _build_ra_spill(a: FMI, b: FMI, config: MergeConfig):
    """The numpy backend's search phase: B's sequences in
    config.sequence_blocks blocks through the host trie search
    (ops/search_np.py; the reference's sequence-block decomposition,
    fmi.cpp:351-357), each block's runs emitted into the spill ladder."""
    from ..ops import search_np
    from ..utils.ranges import get_bounds

    spill = _new_spill(config)
    for blk in get_bounds((0, b.sequences() - 1), config.sequence_blocks):
        values, counts = search_np.build_rank_array(
            a.rank_index, a.alpha.C.astype(np.int64),
            b.rank_index, b.alpha.C.astype(np.int64),
            a.sequences(), b.sequences(),
            sigma=a.alpha.sigma, b_seq_range=blk)
        spill.emit(values, counts)
    return spill


def _build_ra(a: FMI, b: FMI, config: MergeConfig):
    """The search phase.  backend='numpy': _build_ra_spill.  On more than
    one mesh entry: _build_ra_mesh.  Otherwise on config.device: the walk
    over B's read text where walk_creads gives it, the trie search
    otherwise.  Either way B's reads go in blocks sized before the search,
    into a BlockedRA bounded by the ladder's flags, and the stream is
    primed so the first chunk exists before any output is written."""
    from ..ops.ra_stream import blocked_walk
    from ..ops.search_torch import blocked_search
    from ..ops.walk_torch import build_walk_planes

    if config.backend == "numpy":
        return _build_ra_spill(a, b, config)
    mesh = config.mesh()
    if len(mesh) > 1:
        return _build_ra_mesh(a, b, config, mesh)
    ra = _blocked_ra(config)
    creads = walk_creads(b, config)
    index = a.device_index(config.device)
    if creads is not None:
        max_len, r_total = creads.shape
        blocked_walk(index, build_walk_planes(index.rec), creads,
                     _n_blocks(config, b, r_total, max_len), a.sequences(),
                     ra=ra)
    else:
        # a block emits at most its bases plus its sequences; the average
        # read length stands in for the block's own
        seqs = b.sequences()
        per_read = b.size() // max(1, seqs) + 2
        blocked_search(index, b.device_index(config.device), a.sequences(),
                       seqs, _n_blocks(config, b, seqs, per_read),
                       config.streamed, ra=ra)
    return _prime_stream(ra)


def _build_ra_mesh(a: FMI, b: FMI, config: MergeConfig, mesh):
    """The search phase on a mesh of more than one entry, by the JAX
    package's routes in its order (bwtmerge_tpu/models/merge.py:311-408,
    :481-492):

    1. the walk (parallel/mesh.sharded_walk_packed_ra) where walk_creads
       gives B's reads and a shard's emissions fit WALK_BLOCK_EMITS;
    2. placement 'sharded': _sharded_index_search into the spill ladder;
    3. more sequence blocks than entries: the dynamic block queue
       (parallel/mesh.dynamic_block_search) into the spill ladder;
    4. otherwise one sequence block a shard (parallel/mesh.
       sharded_packed_ra).

    B's reads are decoded, under search='walk', on the first entry."""
    from ..parallel.mesh import (dynamic_block_search, sharded_packed_ra,
                                 sharded_walk_packed_ra)

    n_dev = len(mesh)
    creads = walk_creads(b, config, mesh[0])
    if creads is not None:
        max_len, r_total = creads.shape
        if max_len * -(-r_total // n_dev) <= WALK_BLOCK_EMITS:
            return _prime_stream(sharded_walk_packed_ra(
                a.device_index(mesh[0]), creads, mesh=mesh,
                a_sequences=a.sequences(), ra=_blocked_ra(config)))
    if _resolve_placement(config, a, b, mesh) == "sharded":
        return _sharded_index_search(a, b, config, mesh, _new_spill(config))
    a_idx, b_idx = a.device_index(mesh[0]), b.device_index(mesh[0])
    if config.sequence_blocks > n_dev:
        spill = _new_spill(config)
        dynamic_block_search(a_idx, b_idx, a.sequences(), b.sequences(),
                             spill.emit, n_blocks=config.sequence_blocks,
                             mesh=mesh, streamed=config.streamed)
        return spill
    return _prime_stream(sharded_packed_ra(
        a_idx, b_idx, a.sequences(), b.sequences(), mesh=mesh,
        streamed=config.streamed, ra=_blocked_ra(config)))


DEVICE_MEMORY_SHARE = 0.5   # of a device's memory the two record tables may
                            # take under the 'auto' placement; the rest is
                            # the search's frontier, emissions and sorts


def _device_memory(dev) -> int:
    """Bytes of memory of a mesh entry: the card's, or the host's for a CPU
    entry."""
    import torch

    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _resolve_placement(config: MergeConfig, a: FMI, b: FMI, mesh) -> str:
    """'replicated' or 'sharded' from the config and, under 'auto', the
    record tables' bytes against the per-device budget (under replication
    both tables live on every entry, so the budget compares their SUM).
    The default budget is DEVICE_MEMORY_SHARE of the smallest entry's
    memory, not the JAX package's 12 GiB of a TPU v5e chip."""
    from ..ops.rank_torch import BLK, REC

    placement = config.index_placement
    if len(mesh) <= 1:
        return "replicated"
    if placement != "auto":
        return placement
    budget = config.hbm_budget_bytes or int(
        DEVICE_MEMORY_SHARE * min(_device_memory(d) for d in set(mesh)))
    rec_bytes = ((a.size() + b.size()) // BLK + 2) * REC * 4
    return "sharded" if rec_bytes > budget else "replicated"


def _sharded_index_search(a: FMI, b: FMI, config: MergeConfig, mesh, spill):
    """Search with BOTH record tables block-sharded over the mesh
    (ops/rank_sharded.py): each entry holds only its slab.  B's sequences
    go in config.sequence_blocks blocks, each block's runs into the spill
    ladder."""
    from ..ops.rank_sharded import ShardedFMIndex, wavefront_search_sharded
    from ..utils.ranges import get_bounds

    a_idx = ShardedFMIndex.build(a.runs, a.alpha.counts(), mesh=mesh)
    b_idx = ShardedFMIndex.build(b.runs, b.alpha.counts(), mesh=mesh)
    for sp, ep in get_bounds((0, b.sequences() - 1), config.sequence_blocks):
        values, counts, _ = wavefront_search_sharded(a_idx, b_idx, sp, ep,
                                                     a.sequences())
        spill.emit(values, counts)
    return spill


def _interleave(a_runs, b_runs, ra_values, ra_counts, config: MergeConfig):
    """Merged RunArrays from a rank array held whole on the host: the native
    C++ interleave, or, with interleave='device', the scatters of
    ops/interleave_torch.py on config.device.  A native library that does
    not build raises."""
    if config.interleave == "device":
        from ..ops.interleave_torch import interleave_torch

        return interleave_torch(a_runs, b_runs, ra_values, ra_counts,
                                config.device)
    from ..native import interleave_native

    return interleave_native(a_runs, b_runs, ra_values, ra_counts)
