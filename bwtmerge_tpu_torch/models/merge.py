"""Two-input merge on one torch device: FMI(A) + FMI(B) -> FMI(A ∪ B).

Port of the walk path of bwtmerge_tpu/models/merge.py (merge_fmi,
merge_fmi_to_file, _try_walk_search).  The search phase walks every read
of B backward through A's device index (ops/walk_torch.py); the rank array
streams to the host block by block (ops/ra_stream.py) into the JAX
package's native interleave and format writers, reused as they are.

The walk needs B's read text, from its `.reads4` sidecar, gated by the JAX
package's consistency check.  A B without a usable sidecar needs the trie
search or the device read decode, which this port does not have yet
(ROADMAP slices 3 and 2): WalkUnavailableError says so.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from bwtmerge_tpu.models.merge import _creads_consistent, _prime_stream
from bwtmerge_tpu.utils.metrics import PhaseTimer

from ..kernels import resolve_device
from .fmi import FMI

WALK_MAX_LEN = 1 << 14            # longest read the walk takes (as the JAX path)
WALK_BLOCK_EMITS = 1 << 28        # emission lanes per read block (~10 GB of
                                  # walk, unique and sort temporaries)
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
    search:        'auto' or 'walk' (both need B's read-text sidecar)
    """

    device: str = "cuda"
    temp_dir: str = "."
    device_blocks: int = 0
    search: str = "auto"
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


def walk_creads(b: FMI) -> np.ndarray:
    """B's read text in walk layout, from its sidecar, once it passes the
    JAX package's consistency gate; raises WalkUnavailableError otherwise."""
    if b.sequences() == 0:
        raise WalkUnavailableError(
            "B holds no reads; the trie search (ROADMAP slice 3) merges it")
    creads = b.creads()
    if creads is not None and not _creads_consistent(creads, b):
        creads = None
        b.creads_path = None
    if creads is None:
        raise WalkUnavailableError(
            "B has no usable read-text sidecar (.reads4); merging it needs "
            "the device read decode (ROADMAP slice 2) or the trie search "
            "(ROADMAP slice 3), which this port does not have yet")
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

    creads = walk_creads(b)
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
