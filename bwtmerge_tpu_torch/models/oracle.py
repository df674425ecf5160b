"""Ground-truth oracles: direct BWT construction and pattern counting.

The reference ships no test suite (SURVEY.md §4); this module is the root of our
test pyramid. It builds multi-sequence BWTs directly from the sequences via a
numpy suffix array (prefix doubling), so engine outputs can be checked against
first principles, and counts pattern occurrences by plain string scanning.

Conventions (matching SGA/RopeBWT collections, which the reference merges):
- A collection is a list of sequences over comp values 1..sigma-1 (no endmarkers).
- Each sequence k is terminated by a distinct endmarker $_k; endmarkers compare
  less than every character and $_i < $_j iff i < j.
- BWT[i] is the character preceding suffix SA[i] *within its own sequence*,
  wrapping to the sequence's endmarker (comp 0) at sequence starts.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .runs import RunArrays


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of an integer sequence by prefix doubling. O(n log^2 n)."""
    text = np.asarray(text, dtype=np.int64)
    n = text.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(text, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    sorted_vals = text[order]
    rank[order] = np.cumsum(np.concatenate(([0], (sorted_vals[1:] != sorted_vals[:-1]).astype(np.int64))))
    k = 1
    idx = np.arange(n)
    while rank[order[-1]] != n - 1:
        second = np.where(idx + k < n, np.concatenate((rank[k:], np.full(min(k, n), -1)))[:n], -1)
        order = np.lexsort((second, rank))
        combined_first = rank[order]
        combined_second = second[order]
        changed = np.concatenate(
            ([0],
             ((combined_first[1:] != combined_first[:-1])
              | (combined_second[1:] != combined_second[:-1])).astype(np.int64))
        )
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.cumsum(changed)
        k *= 2
    return order


def build_bwt(sequences: Sequence[np.ndarray]) -> RunArrays:
    """Direct BWT of a sequence collection (comp values 1..5 per sequence).

    Every suffix of every '<seq>$_k' is sorted; endmarkers are unique and ordered
    by sequence index, so a plain suffix array over a remapped concatenation gives
    the collection order: endmarker of sequence k -> value k; character c ->
    m + c (m = number of sequences).
    """
    m = len(sequences)
    seqs = [np.asarray(s, dtype=np.int64) for s in sequences]
    if any((s <= 0).any() for s in seqs):
        raise ValueError("sequences must contain comp values >= 1 (no endmarkers)")
    lengths = np.array([s.size for s in seqs], dtype=np.int64)
    n = int(lengths.sum()) + m

    text = np.empty(n, dtype=np.int64)
    seq_of_pos = np.empty(n, dtype=np.int64)
    start_of_seq = np.zeros(m, dtype=np.int64)
    pos = 0
    for k, s in enumerate(seqs):
        start_of_seq[k] = pos
        text[pos : pos + s.size] = m + s
        text[pos + s.size] = k  # endmarker, unique and ordered by k
        seq_of_pos[pos : pos + s.size + 1] = k
        pos += s.size + 1

    sa = suffix_array(text)

    # BWT char = previous char within the same sequence (wrap to endmarker).
    prev_idx = sa - 1
    at_seq_start = (sa == start_of_seq[seq_of_pos[sa]])
    bwt = np.where(at_seq_start, 0, np.where(text[prev_idx] < m, 0, text[prev_idx] - m))
    return RunArrays.from_values(bwt.astype(np.uint8))


def merge_collections(collections: Sequence[Sequence[np.ndarray]]) -> RunArrays:
    """Oracle merge: BWT of the concatenated collections (inputs in order)."""
    merged: List[np.ndarray] = []
    for coll in collections:
        merged.extend(coll)
    return build_bwt(merged)


def rank_array_oracle(a_seqs: Sequence[np.ndarray], b_seqs: Sequence[np.ndarray]) -> np.ndarray:
    """RA[i] = number of A-suffixes <= B-suffix i (B-suffixes in B's SA order).

    Computed from the merged suffix order: in the union collection (A's sequences
    first), position of B-suffix i among all suffixes minus its own B-rank.
    """
    merged = _suffix_origins(a_seqs, b_seqs)
    b_rows = np.flatnonzero(merged == 1)
    return (b_rows - np.arange(b_rows.size)).astype(np.int64)


def _suffix_origins(a_seqs, b_seqs) -> np.ndarray:
    """0/1 array over the union collection's SA: which input owns each row."""
    m_a = len(a_seqs)
    seqs = [np.asarray(s, dtype=np.int64) for s in list(a_seqs) + list(b_seqs)]
    m = len(seqs)
    lengths = np.array([s.size for s in seqs], dtype=np.int64)
    n = int(lengths.sum()) + m
    text = np.empty(n, dtype=np.int64)
    seq_of_pos = np.empty(n, dtype=np.int64)
    pos = 0
    for k, s in enumerate(seqs):
        text[pos : pos + s.size] = m + s
        text[pos + s.size] = k
        seq_of_pos[pos : pos + s.size + 1] = k
        pos += s.size + 1
    sa = suffix_array(text)
    return (seq_of_pos[sa] >= m_a).astype(np.int64)


def count_occurrences(sequences: Sequence[np.ndarray], pattern: np.ndarray) -> int:
    """Number of occurrences of `pattern` across the collection (oracle for
    FMI.find; occurrences never span endmarkers)."""
    pattern = np.asarray(pattern, dtype=np.int64)
    if pattern.size == 0:
        return sum(int(np.asarray(s).size) + 1 for s in sequences)
    total = 0
    for s in sequences:
        s = np.asarray(s, dtype=np.int64)
        if s.size < pattern.size:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(s, pattern.size)
        total += int(np.all(windows == pattern, axis=1).sum())
    return total


def random_collection(rng: np.random.Generator, n_seqs: int, min_len: int = 20,
                      max_len: int = 200, sigma: int = 6) -> List[np.ndarray]:
    """Random DNA-like collection for tests (comp values 1..sigma-1)."""
    out = []
    for _ in range(n_seqs):
        length = int(rng.integers(min_len, max_len + 1))
        out.append(rng.integers(1, sigma, size=length).astype(np.int64))
    return out
