"""Two-input merge on one torch device: FMI(A) + FMI(B) -> FMI(A ∪ B).

Port of the walk path of bwtmerge_tpu/models/merge.py (merge_fmi,
merge_fmi_to_file, merge_files, _try_walk_search).  The search phase walks
every read of B backward through A's device index (ops/walk_torch.py); the
rank array streams to the host block by block (ops/ra_stream.py) into the
JAX package's native interleave and format writers, reused as they are.

The walk needs B's read text: its `.reads4` sidecar, gated by the JAX
package's consistency check, or, with search='walk', B's reads decoded on
the device from its own BWT (ops/decode_torch.py), optionally cached as a
sidecar.  A B without a usable sidecar under search='auto' needs the trie
search, which this port does not have yet (ROADMAP slice 3):
WalkUnavailableError says so.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from bwtmerge_tpu.models.merge import (_creads_consistent, _prime_stream,
                                       _write_decoded_sidecar)
from bwtmerge_tpu.utils.metrics import PhaseTimer

from ..kernels import resolve_device
from ..ops.walk_torch import WALK_BLOCK_EMITS, WALK_MAX_LEN
from .fmi import FMI

AUTO_BLOCKS_MIN_BASES = 16 * 1024 * 1024   # two blocks from here up


class WalkUnavailableError(ValueError):
    """The walk search cannot run for this B (no usable read-text sidecar,
    no reads, or reads beyond WALK_MAX_LEN)."""


@dataclass
class MergeConfig:
    """Merge parameters of the port.

    device:        torch device of the search ('cuda' or 'cpu'); 'cuda'
                   without CUDA raises
    temp_dir:      scratch directory (-d); the walk path spills nothing
    device_blocks: read blocks walked as separate launches, so block k's
                   rank-array copy overlaps block k+1's walk (0 = auto: 2
                   once B holds 16 Mbp)
    search:        'auto' (needs B's read-text sidecar) or 'walk' (decodes
                   B's reads on the device when it has no usable sidecar)
    cache_sidecar: write a device-decoded B's reads as its sidecar, so that
                   later merges skip the decode (only for B read from a file)
    """

    device: str = "cuda"
    temp_dir: str = "."
    device_blocks: int = 0
    search: str = "auto"
    cache_sidecar: bool = False
    verbose: bool = False
    timer: PhaseTimer = field(default_factory=PhaseTimer)

    def sanitize(self) -> "MergeConfig":
        self.device_blocks = max(0, self.device_blocks)
        if self.search not in ("auto", "walk"):
            raise ValueError(
                f"search must be auto/walk, got {self.search!r} (the trie "
                "search is ROADMAP slice 3)")
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
    from bwtmerge_tpu.native import interleave_streaming

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
    from bwtmerge_tpu.formats.streaming import write_bwt_stream
    from bwtmerge_tpu.native import interleave_stream_chunks
    from bwtmerge_tpu.utils.pipeline import prefetch_chunks

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
    B's reads come from its sidecar next to b_path, or from the device
    decode under search='walk', cached there with cache_sidecar.  (The
    JAX package's merge_files never looks for a sidecar: its trie search
    needs none, and this port has no trie yet.)  `stats` receives
    a_bases, b_bases and the windowed interleave's peak window."""
    from bwtmerge_tpu.formats.sidecar import sidecar_path
    from bwtmerge_tpu.formats.streaming import write_bwt_stream
    from bwtmerge_tpu.formats.streaming_read import (read_bwt_chunks,
                                                     read_bwt_streaming)
    from bwtmerge_tpu.native.windowed import interleave_windowed_chunks

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


def walk_creads(b: FMI, config: MergeConfig) -> np.ndarray:
    """B's read text in walk layout: from its sidecar once it passes the JAX
    package's consistency gate, or, with search='walk', decoded on the
    device.  Raises WalkUnavailableError when the walk cannot take B."""
    from ..ops.decode_torch import decode_creads

    if b.sequences() == 0:
        raise WalkUnavailableError(
            "B holds no reads; the trie search (ROADMAP slice 3) merges it")
    creads = b.creads()
    if creads is not None and not _creads_consistent(creads, b):
        print("ignoring stale reads sidecar (character counts do not match "
              "the BWT)", file=sys.stderr)
        creads = None
        b.creads_path = None
    if creads is None:
        if config.search != "walk":
            raise WalkUnavailableError(
                "B has no usable read-text sidecar (.reads4); merging it "
                "needs --search walk (decodes B's reads on the device) or "
                "the trie search (ROADMAP slice 3), which this port does "
                "not have yet")
        creads = decode_creads(b.device_index(config.device), b.sequences(),
                               b.size(), max_len_cap=WALK_MAX_LEN)
        if creads is None:
            raise WalkUnavailableError(
                f"B has a read of {WALK_MAX_LEN} or more characters; the trie "
                "search (ROADMAP slice 3) merges it")
        b.attach_creads(creads)
        if config.cache_sidecar and b.creads_path:
            _write_decoded_sidecar(b.creads_path, creads)
    if creads.shape[0] > WALK_MAX_LEN:
        raise WalkUnavailableError(
            f"B has reads longer than {WALK_MAX_LEN}; the trie search "
            "(ROADMAP slice 3) merges them")
    return creads


def _build_ra(a: FMI, b: FMI, config: MergeConfig):
    """The walk search: B's reads walked through A's device index in read
    blocks, primed so the first chunk exists before any output is written."""
    from ..ops.ra_stream import blocked_walk
    from ..ops.walk_torch import build_cplanes

    creads = walk_creads(b, config)
    index = a.device_index(config.device)
    cpl = build_cplanes(index.rec)
    max_len, r_total = creads.shape
    n_blk = config.device_blocks
    if n_blk == 0:
        n_blk = 2 if b.size() >= AUTO_BLOCKS_MIN_BASES else 1
    while max_len * -(-r_total // n_blk) > WALK_BLOCK_EMITS and n_blk < r_total:
        n_blk *= 2
    ra = blocked_walk(index, cpl, creads, n_blk, a.sequences())
    primed = _prime_stream(ra)
    if primed is None:
        raise RuntimeError("walk rank-array stream failed to start")
    return primed
