"""BWT construction from raw reads, with optional RLO reordering.

Port of bwtmerge_tpu/models/build.py.  The reference consumes BWTs prebuilt
by external tools (ropebwt / ropebwt2, paper.tex:274), so its "reads ->
mergeable BWT" step needs a second codebase.  Here it is built in: a
multi-string suffix-array construction (prefix doubling over the whole
collection, on the host in models/oracle.py or on a torch device in
ops/sa_torch.py) plus optional **reverse-lexicographic (RLO) read
ordering**, which the paper measures cutting both build time and memory on
real read sets (paper.tex:278), because sorting reads by their reversed
text groups equal suffixes and shrinks the run count of the BWT.

Reordering the reads of a collection never changes pattern occurrence counts
(each read keeps its own endmarker; only endmarker ranks permute), so an
RLO-built BWT is query-equivalent to the original-order BWT (pinned by
tests/test_torch_build.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.alphabet import DEFAULT_CHAR2COMP, Alphabet
from . import oracle
from .runs import RunArrays

BACKENDS = ("auto", "torch", "sharded", "numpy")


def rlo_order(sequences: Sequence[np.ndarray]) -> np.ndarray:
    """Permutation sorting reads into reverse-lexicographic order.

    RLO compares the REVERSED reads lexicographically; a read that is a
    suffix of a longer read sorts first (the pad value 0 compares below
    every character).  Vectorized: one [m, max_len] key matrix of reversed
    reads + a single np.lexsort, no Python-level comparisons.
    """
    m = len(sequences)
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    seqs = [np.asarray(s) for s in sequences]
    max_len = max((s.size for s in seqs), default=0)
    if max_len == 0:
        return np.arange(m, dtype=np.int64)
    keys = np.zeros((m, max_len), dtype=np.uint8)
    for i, s in enumerate(seqs):
        keys[i, : s.size] = s[::-1]
    # lexsort's LAST key is primary: column 0 (each read's final character)
    # is the most significant position in reverse-lexicographic order
    return np.lexsort(tuple(keys[:, j] for j in range(max_len - 1, -1, -1)))


# Collections below this many total positions build faster on the host than
# the device path's dispatch and transfers cost.
_DEVICE_BUILD_MIN_POSITIONS = 1 << 20


def _use_device_build(backend: str, n_positions: int, device) -> bool:
    if backend == "numpy":
        return False
    if backend == "torch":
        return True
    # auto: the device only when the collection is big enough to pay for the
    # dispatch and the device asked for is a CUDA device
    if n_positions < _DEVICE_BUILD_MIN_POSITIONS:
        return False
    import torch

    return torch.device(device).type == "cuda"


def build_from_reads(sequences: Sequence[np.ndarray], rlo: bool = False,
                     backend: str = "auto", device="cuda",
                     stats: Optional[dict] = None, mesh=None
                     ) -> Tuple[RunArrays, np.ndarray]:
    """BWT of a read collection (comp values 1..sigma-1 per read).

    With rlo=True the reads are first sorted reverse-lexicographically
    (run-count-minimizing heuristic, paper.tex:278).  Returns the RunArrays
    and the read order actually used (identity when rlo=False).

    backend: 'numpy' (host prefix doubling, models/oracle.py), 'torch'
    (prefix doubling by torch.sort on `device`, ops/sa_torch.py), or 'auto'
    (`device` when it is a CUDA device and the collection holds 2^20
    positions or more; the host otherwise), or 'sharded' (the suffix sort
    spread over `mesh`, default every GPU, or one CPU entry for
    device='cpu': parallel/sort_distributed.py, for collections whose
    suffix array exceeds one device's memory).
    `sequences` may be a list of arrays or a packed (flat, lengths) tuple.
    `stats`, when given, receives the device build's positions, rounds and
    seconds (ops/sa_torch.build_bwt_device).
    """
    from ..ops.sa_torch import pack_collection

    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {'/'.join(BACKENDS)}, got {backend!r}")
    flat, lengths = pack_collection(sequences)
    n_positions = int(lengths.sum()) + lengths.size
    if backend == "sharded":
        from ..ops.sa_torch import _reorder_packed
        from ..parallel.mesh import make_mesh
        from ..parallel.sort_distributed import (build_bwt_sharded,
                                                 rlo_order_sharded)

        mesh = mesh or make_mesh(device=device)
        if rlo:
            order = rlo_order_sharded((flat, lengths), mesh)
            flat, lengths = _reorder_packed(flat, lengths, order)
        else:
            order = np.arange(lengths.size, dtype=np.int64)
        return build_bwt_sharded((flat, lengths), mesh), order
    if _use_device_build(backend, n_positions, device):
        from ..ops.sa_torch import (_reorder_packed, build_bwt_device,
                                    rlo_order_device)

        if rlo:
            order = rlo_order_device((flat, lengths), device)
            packed = _reorder_packed(flat, lengths, order)
        else:
            order = np.arange(lengths.size, dtype=np.int64)
            packed = (flat, lengths)
        return build_bwt_device(packed, device, stats), order
    ends = np.cumsum(lengths)
    seqs = [flat[e - ln:e].astype(np.int64)
            for e, ln in zip(ends, lengths)]
    order = rlo_order(seqs) if rlo else np.arange(len(seqs), dtype=np.int64)
    return oracle.build_bwt([seqs[i] for i in order]), order


def rlo_reorder(fmi, backend: str = "auto", device="cuda") -> RunArrays:
    """RLO-reorder the reads of an EXISTING BWT (bwt_convert --rlo).

    Extracts every read with batched lockstep LF walks (FMI.extract_all),
    sorts them reverse-lexicographically, and rebuilds, turning an
    arbitrary-order BWT into the run-count-minimizing order without access
    to the original reads.  Query-equivalent by construction.
    """
    runs, _ = build_from_reads(fmi.extract_all(), rlo=True, backend=backend,
                               device=device)
    return runs


def read_plain_reads(path: str, char2comp: np.ndarray = DEFAULT_CHAR2COMP
                     ) -> List[np.ndarray]:
    """Parse a plain reads file: one read per line (empty lines skipped).

    Character mapping follows the reference's PlainFormat semantics
    (support.cpp:39-62): ACGT/acgt map to comps 1..4, every other byte maps
    to N, EXCEPT endmarker characters ('$' and NUL, comp 0), which are never
    legal inside a read and raise with the offending file:line."""
    flat, lengths = read_plain_reads_packed(path, char2comp)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    return [flat[s:e].astype(np.int64) for s, e in zip(starts, ends)]


def read_plain_reads_packed(path: str,
                            char2comp: np.ndarray = DEFAULT_CHAR2COMP
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """read_plain_reads in packed (flat int32, lengths int64) form: one
    vectorized pass over the file bytes instead of a Python loop per read.
    Feed the result straight to build_from_reads."""
    data = np.fromfile(path, dtype=np.uint8)
    if data.size and data[-1] != 0x0A:
        data = np.concatenate([data, np.array([0x0A], np.uint8)])
    if data.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    nl = np.flatnonzero(data == 0x0A)
    starts = np.concatenate([[0], nl[:-1] + 1])
    ends = nl.copy()
    # \r\n line endings: drop the trailing \r
    crlf = ends > starts
    crlf[crlf] = data[ends[crlf] - 1] == 0x0D
    ends = ends - crlf.astype(ends.dtype)
    keep = ends > starts                      # skip empty lines
    starts, ends = starts[keep], ends[keep]

    line_mask = np.zeros(data.size + 1, np.int8)
    np.add.at(line_mask, starts, 1)
    np.add.at(line_mask, ends, -1)
    inside = np.cumsum(line_mask[:-1]).astype(bool)
    flat = char2comp[data[inside]].astype(np.int32)
    lengths = (ends - starts).astype(np.int64)
    if (flat == 0).any():
        # reconstruct the offending file:line for the error message
        bad = int(np.flatnonzero(flat == 0)[0])
        row = int(np.searchsorted(np.cumsum(lengths), bad, side="right"))
        col = bad - (int(np.cumsum(lengths)[row - 1]) if row else 0)
        ch = chr(data[starts[row] + col])
        # line number counts every line in the file, empty ones included
        ln = int(np.searchsorted(nl, starts[row], side="left")) + 1
        raise ValueError(
            f"{path}:{ln}: endmarker character {ch!r} inside a read")
    return flat, lengths


def alphabet_for(runs: RunArrays, sigma: int = 6) -> Alphabet:
    return Alphabet.from_counts(runs.counts(sigma))
