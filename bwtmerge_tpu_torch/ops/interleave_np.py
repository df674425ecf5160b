"""Interleave two RLE BWTs by a rank array — numpy backend.

Replaces the reference's sequential 2-thread producer/consumer interleave
(RABuffer/mergeRA/mergeBWT, bwt.cpp:152-282) with position arithmetic:

  output index of B position j   = RA_expanded[j] + j
  output index of A position i   = i + (# B positions with RA value <= i)

Both are prefix-sum expressions over the (sorted, unique) RA runs, so the merge
is embarrassingly parallel — the same formulation the device backend uses with
segmented scatter instead of per-position materialization.
"""

from __future__ import annotations

import numpy as np

from ..models.runs import RunArrays


def interleave(a: RunArrays, b: RunArrays,
               ra_values: np.ndarray, ra_counts: np.ndarray) -> RunArrays:
    """Merged RLE BWT of A and B according to the rank array.

    ra_values must be sorted unique a-positions; sum(ra_counts) == b.size().
    """
    n_a, n_b = a.size(), b.size()
    if int(ra_counts.sum()) != n_b:
        raise ValueError(f"rank array covers {int(ra_counts.sum())} values, expected {n_b}")

    out = np.empty(n_a + n_b, dtype=np.uint8)

    # B positions: j -> ra_expanded[j] + j
    ra_expanded = np.repeat(ra_values, ra_counts)
    out[ra_expanded + np.arange(n_b, dtype=np.int64)] = b.decode()

    # A positions: i -> i + (# B values <= i)
    cum = np.zeros(ra_values.size + 1, dtype=np.int64)
    np.cumsum(ra_counts, out=cum[1:])
    i = np.arange(n_a, dtype=np.int64)
    shift = cum[np.searchsorted(ra_values, i, side="right")]
    out[i + shift] = a.decode()

    return RunArrays.from_values(out)
