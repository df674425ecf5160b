"""Two-input merge on one torch device: FMI(A) + FMI(B) -> FMI(A ∪ B).

Port of bwtmerge_tpu/models/merge.py (merge_fmi, merge_fmi_to_file,
merge_files, _try_walk_search and the device route of _build_ra_spill).
The search phase builds the rank array on the device and streams it to the
host block by block (ops/ra_stream.py) into the native interleave and the
format writers.

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
"""

from __future__ import annotations

import itertools
import sys
from dataclasses import dataclass, field
from typing import Optional

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
    temp_dir:      scratch directory (-d): the k-way fold's spill files and
                   the chain's intermediate folds
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
    temp_dir: str = "."
    device_blocks: int = 0
    search: str = "auto"
    streamed: Optional[bool] = None
    cache_sidecar: bool = False
    verbose: bool = False
    timer: PhaseTimer = field(default_factory=PhaseTimer)

    def sanitize(self) -> "MergeConfig":
        self.device_blocks = max(0, self.device_blocks)
        if self.search not in ("auto", "walk", "trie"):
            raise ValueError(
                f"search must be auto/walk/trie, got {self.search!r}")
        resolve_device(self.device)
        return self


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
        # capacity hint: every A/B run appears at most once plus at most two
        # seam splits per RA run
        hint = a.runs.n_runs + b.runs.n_runs + 2 * ra.n_runs + 16
        merged_runs = interleave_streaming(a.runs, b.runs, ra.stream(),
                                           hint_runs=hint)

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
    if creads.shape[1] != b.sequences():
        return False
    have = np.bincount(creads.reshape(-1).astype(np.uint8),
                       minlength=8).astype(np.int64)
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


def walk_creads(b: FMI, config: MergeConfig) -> Optional[np.ndarray]:
    """B's read text in walk layout, or None where the merge searches the
    trie: search='trie'; B holds no reads; under 'auto', B has no sidecar
    that passes the consistency gate; under 'walk', the device decode meets
    a read of WALK_MAX_LEN or more characters."""
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
        creads = decode_creads(b.device_index(config.device), b.sequences(),
                               b.size(), max_len_cap=WALK_MAX_LEN)
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


def _build_ra(a: FMI, b: FMI, config: MergeConfig) -> _PrimedStream:
    """The search phase on config.device: the walk over B's read text where
    walk_creads gives it, the trie search otherwise.  Either way B's reads
    go in blocks sized before the search, and the stream is primed so the
    first chunk exists before any output is written."""
    from ..ops.ra_stream import blocked_walk
    from ..ops.search_torch import blocked_search
    from ..ops.walk_torch import build_cplanes

    creads = walk_creads(b, config)
    index = a.device_index(config.device)
    if creads is not None:
        max_len, r_total = creads.shape
        ra = blocked_walk(index, build_cplanes(index.rec), creads,
                          _n_blocks(config, b, r_total, max_len),
                          a.sequences())
    else:
        # a block emits at most its bases plus its sequences; the average
        # read length stands in for the block's own
        seqs = b.sequences()
        per_read = b.size() // max(1, seqs) + 2
        ra = blocked_search(index, b.device_index(config.device),
                            a.sequences(), seqs,
                            _n_blocks(config, b, seqs, per_read),
                            config.streamed)
    return _prime_stream(ra)
