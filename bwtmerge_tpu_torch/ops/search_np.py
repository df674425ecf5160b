"""Rank-array construction by wavefront search — numpy backend.

Batched re-design of the reference's reverse-trie DFS (buildRA, fmi.cpp:261-334):
instead of a per-thread explicit stack with 3 node-size-dependent LF strategies,
the whole frontier advances one trie depth per step with batched rank queries.
Correctness matches the DFS exactly — the set of visited (a_pos, b_range) nodes is
identical, only the visit order differs, and the rank array is order-independent
(it is re-sorted by a-position before interleaving).

Shared-prefix batching (the reference's key trick, paper.tex:182-184) is inherent:
a frontier node carries a whole lexicographic range of B-suffixes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .rank_np import RankIndex


def build_rank_array(
    a_rank: RankIndex,
    a_C: np.ndarray,
    b_rank: RankIndex,
    b_C: np.ndarray,
    a_sequences: int,
    b_sequences: int,
    sigma: int = 6,
    b_seq_range: Tuple[int, int] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute the rank array RA of B relative to A as sorted unique runs.

    Returns (values, counts): values int64[T] strictly increasing a-positions,
    counts int64[T]; sum(counts) == size of the B block searched. RA semantics:
    counts[t] B-suffixes have exactly values[t] A-suffixes <= them.

    b_seq_range: closed range of B sequence ranks to search (a sequence block in
    the sense of fmi.cpp:351-357); default all of B.
    """
    if b_seq_range is None:
        b_seq_range = (0, b_sequences - 1)
    sp0, ep0 = b_seq_range
    if ep0 < sp0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    # Frontier: (a_pos, b_sp, b_ep). Root: all endmarker rows of the block rank
    # a.sequences() in A (fmi.cpp:286).
    a_pos = np.array([a_sequences], dtype=np.int64)
    b_sp = np.array([sp0], dtype=np.int64)
    b_ep = np.array([ep0], dtype=np.int64)

    values_chunks = []
    counts_chunks = []

    while a_pos.size:
        values_chunks.append(a_pos)
        counts_chunks.append(b_ep - b_sp + 1)

        # Children for all characters 1..sigma-1 at once.
        # ranks at both range ends of B, and at a_pos in A.
        rb_sp = b_rank.ranks_all(b_sp)          # [F, sigma]
        rb_ep = b_rank.ranks_all(b_ep + 1)      # [F, sigma]
        ra_pos = a_rank.ranks_all(a_pos)        # [F, sigma]

        cs = np.arange(1, sigma, dtype=np.int64)
        child_sp = b_C[cs][None, :] + rb_sp[:, 1:sigma]
        child_ep = b_C[cs][None, :] + rb_ep[:, 1:sigma] - 1
        child_a = a_C[cs][None, :] + ra_pos[:, 1:sigma]
        keep = child_ep >= child_sp

        a_pos = child_a[keep]
        b_sp = child_sp[keep]
        b_ep = child_ep[keep]

    values = np.concatenate(values_chunks) if values_chunks else np.zeros(0, np.int64)
    counts = np.concatenate(counts_chunks) if counts_chunks else np.zeros(0, np.int64)
    return compact_rank_array(values, counts)


def compact_rank_array(values: np.ndarray, counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort RA runs by a-position and sum counts of equal positions.

    The vector analog of the reference's RLArray sort+merge ladder
    (support.h:416-453, fmi.cpp:220-257).
    """
    if values.size == 0:
        return values.astype(np.int64), counts.astype(np.int64)
    if np.all(values[1:] >= values[:-1]):
        # already sorted (device-compacted chunks, single-source streams):
        # skip the argsort — an O(n) check vs O(n log n) sort at tens of
        # millions of runs
        return compact_sorted_rank_array(np.asarray(values), np.asarray(counts))
    order = np.argsort(values, kind="stable")
    return compact_sorted_rank_array(values[order], counts[order])


def compact_sorted_rank_array(v: np.ndarray, k: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """compact_rank_array for already-sorted values (e.g. sorted on device):
    segment-head detection + one reduceat, no argsort."""
    if v.size == 0:
        return v.astype(np.int64), k.astype(np.int64)
    starts = np.empty(v.size, dtype=bool)
    starts[0] = True
    np.not_equal(v[1:], v[:-1], out=starts[1:])
    idx = np.flatnonzero(starts)
    if idx.size == v.size:  # all unique — common for device-compacted chunks
        return v.astype(np.int64), k.astype(np.int64)
    # segment sums via cumsum differences (vectorized; reduceat loops per run)
    cs = np.cumsum(k, dtype=np.int64)
    last = np.concatenate((idx[1:] - 1, [v.size - 1]))
    sums = np.diff(np.concatenate(([0], cs[last])))
    return v[idx].astype(np.int64), sums


def merge_rank_arrays(a: Tuple[np.ndarray, np.ndarray],
                      b: Tuple[np.ndarray, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """2-way merge of two sorted unique RA run lists (RLArray merge analog).

    Vectorized linear merge: each side's output positions are its own index
    plus a binary search into the other side — two searchsorted passes and
    two scatters instead of an O(n log n) argsort of the concatenation
    (which dominated the spill ladder at tens of millions of runs)."""
    va, ka = a
    vb, kb = b
    if va.size == 0:
        return np.asarray(vb, np.int64), np.asarray(kb, np.int64)
    if vb.size == 0:
        return np.asarray(va, np.int64), np.asarray(ka, np.int64)
    pos_a = np.arange(va.size, dtype=np.int64) + np.searchsorted(vb, va, side="left")
    pos_b = np.arange(vb.size, dtype=np.int64) + np.searchsorted(va, vb, side="right")
    n = va.size + vb.size
    v = np.empty(n, dtype=np.int64)
    k = np.empty(n, dtype=np.int64)
    v[pos_a] = va
    v[pos_b] = vb
    k[pos_a] = ka
    k[pos_b] = kb
    return compact_sorted_rank_array(v, k)
