"""Batched rank/LF over an RLE BWT — numpy backend.

Replaces the reference's per-query block decode (BWT::rank, bwt.cpp:318-341;
one sd_vector rank + <=64-byte sequential Run::read scan per query) with a
vectorized two-array form: searchsorted over run start positions + per-run
cumulative occurrence tables. This is also the memory layout the device index
mirrors (ops/rank_torch.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.runs import RunArrays, SIGMA


@dataclass
class RankIndex:
    """Flat rank index over maximal runs.

    run_starts: int64[R+1]  text position where run r starts; [R] = size
    occ:        int64[R+1, sigma]  occ[r, c] = # of c in positions [0, run_starts[r])
    syms:       uint8[R]
    """

    syms: np.ndarray
    run_starts: np.ndarray
    occ: np.ndarray

    @classmethod
    def build(cls, runs: RunArrays, sigma: int = SIGMA) -> "RankIndex":
        r = runs.n_runs
        run_starts = np.zeros(r + 1, dtype=np.int64)
        np.cumsum(runs.lens, out=run_starts[1:])
        occ = np.zeros((r + 1, sigma), dtype=np.int64)
        if r:
            onehot = np.zeros((r, sigma), dtype=np.int64)
            onehot[np.arange(r), runs.syms] = runs.lens
            np.cumsum(onehot, axis=0, out=occ[1:])
        return cls(syms=runs.syms.copy(), run_starts=run_starts, occ=occ)

    @property
    def size(self) -> int:
        return int(self.run_starts[-1])

    def rank(self, positions, comp) -> np.ndarray:
        """rank(i, c) = # of c in [0, i) for each (i, c) pair; vectorized."""
        i = np.minimum(np.asarray(positions, dtype=np.int64), self.size)
        c = np.asarray(comp, dtype=np.int64)
        k = np.searchsorted(self.run_starts, i, side="right") - 1
        k = np.minimum(k, self.syms.size - 1) if self.syms.size else np.zeros_like(k)
        if self.syms.size == 0:
            return np.zeros_like(i)
        partial = np.where(self.syms[k] == c, i - self.run_starts[k], 0)
        return self.occ[k, c] + partial

    def ranks_all(self, positions) -> np.ndarray:
        """rank(i, c) for all comp values at once: int64[len(positions), sigma]."""
        i = np.minimum(np.asarray(positions, dtype=np.int64), self.size)
        if self.syms.size == 0:
            return np.zeros((i.size, self.occ.shape[1]), dtype=np.int64)
        k = np.searchsorted(self.run_starts, i, side="right") - 1
        k = np.minimum(k, self.syms.size - 1)
        res = self.occ[k].copy()
        res[np.arange(i.size), self.syms[k]] += i - self.run_starts[k]
        return res

    def select(self, i, comp) -> np.ndarray:
        """Position of the i-th (1-based) occurrence of comp
        (reference BWT::select, bwt.cpp:405-427)."""
        i = np.asarray(i, dtype=np.int64)
        c = int(comp)
        k = np.searchsorted(self.occ[:, c], i, side="left") - 1
        k = np.maximum(k, 0)
        return self.run_starts[k] + (i - 1 - self.occ[k, c])

    def access(self, positions) -> np.ndarray:
        """BWT[i] (reference BWT::operator[], bwt.cpp:429-443)."""
        i = np.asarray(positions, dtype=np.int64)
        k = np.searchsorted(self.run_starts, i, side="right") - 1
        return self.syms[np.minimum(k, self.syms.size - 1)]

    def inverse_select(self, positions):
        """(rank(i, BWT[i]), BWT[i]) per position (bwt.cpp:445-464)."""
        i = np.asarray(positions, dtype=np.int64)
        k = np.searchsorted(self.run_starts, i, side="right") - 1
        k = np.minimum(k, self.syms.size - 1)
        sym = self.syms[k]
        rnk = self.occ[k, sym] + (i - self.run_starts[k])
        return rnk, sym


@dataclass
class SparseRankIndex:
    """Block-sampled rank over maximal runs: O(R/stride) memory instead of
    RankIndex's O(R * sigma) occ table (3.7 GB at 77M runs) — built for
    sparse query workloads like the sidecar spot-walk (models/merge.py),
    where a handful of LF chains must not cost a full index build.

    Samples cumulative occ + text position every `stride` runs; a query
    locates its block by binary search over the sampled starts, then scans
    the <= stride runs of that block (vectorized cumsum per query).
    """

    syms: np.ndarray          # uint8[R] (view of the source runs)
    lens: np.ndarray          # int64[R]
    blk_starts: np.ndarray    # int64[NB+1] text position at run block*stride
    blk_occ: np.ndarray       # int64[NB+1, sigma] occ at those runs
    stride: int

    @classmethod
    def build(cls, runs: RunArrays, sigma: int = SIGMA,
              stride: int = 1 << 12) -> "SparseRankIndex":
        syms = np.asarray(runs.syms)
        lens = np.asarray(runs.lens, dtype=np.int64)
        r = syms.size
        idx = np.arange(0, r, stride, dtype=np.int64) if r else np.zeros(1, np.int64)
        nb = idx.size
        blk_starts = np.zeros(nb + 1, np.int64)
        blk_occ = np.zeros((nb + 1, sigma), np.int64)
        if r:
            sums = np.add.reduceat(lens, idx)
            np.cumsum(sums, out=blk_starts[1:])
            for c in range(sigma):
                contrib = np.where(syms == c, lens, 0)
                np.cumsum(np.add.reduceat(contrib, idx), out=blk_occ[1:, c])
        return cls(syms=syms, lens=lens, blk_starts=blk_starts,
                   blk_occ=blk_occ, stride=stride)

    @property
    def size(self) -> int:
        return int(self.blk_starts[-1])

    def inverse_select(self, positions):
        """(rank(i, BWT[i]), BWT[i]) per position; O(stride) scan each."""
        i = np.asarray(positions, dtype=np.int64)
        rnk = np.empty(i.shape, np.int64)
        sym = np.empty(i.shape, np.uint8)
        for q, pos in enumerate(i):
            b = int(np.searchsorted(self.blk_starts, pos, side="right")) - 1
            b = min(max(b, 0), self.blk_starts.size - 2)
            lo = b * self.stride
            hi = min(lo + self.stride, self.syms.size)
            local = np.cumsum(self.lens[lo:hi])
            off = pos - int(self.blk_starts[b])
            k = int(np.searchsorted(local, off, side="right"))
            k = min(k, hi - lo - 1)
            s = int(self.syms[lo + k])
            run_start = int(local[k - 1]) if k else 0
            in_block = int(np.sum(
                self.lens[lo:lo + k][self.syms[lo:lo + k] == s]))
            rnk[q] = int(self.blk_occ[b, s]) + in_block + (off - run_start)
            sym[q] = s
        return rnk, sym

    def rank(self, positions, comps) -> np.ndarray:
        """rank(i, c) = # of c in [0, i) per (i, c) pair; O(stride) scan
        each — sized for sparse verification workloads (e.g. a few hundred
        thousand queries over a multi-Gbp BWT whose full occ table would
        not fit in memory)."""
        i = np.asarray(positions, dtype=np.int64)
        c = np.asarray(comps, dtype=np.int64)
        out = np.empty(i.shape, np.int64)
        size = self.size
        for q in range(i.size):
            pos = min(int(i[q]), size)
            cq = int(c[q])
            b = int(np.searchsorted(self.blk_starts, pos, side="right")) - 1
            b = min(max(b, 0), self.blk_starts.size - 2)
            lo = b * self.stride
            hi = min(lo + self.stride, self.syms.size)
            local = np.cumsum(self.lens[lo:hi])
            off = pos - int(self.blk_starts[b])
            k = int(np.searchsorted(local, off, side="right"))
            k = min(k, hi - lo - 1)
            mask = self.syms[lo:lo + k] == cq
            in_block = int(np.sum(self.lens[lo:lo + k][mask]))
            if k < hi - lo and int(self.syms[lo + k]) == cq:
                run_start = int(local[k - 1]) if k else 0
                in_block += max(0, off - run_start)
            out[q] = int(self.blk_occ[b, cq]) + in_block
        return out

    def batch_backward_search(self, C: np.ndarray, patterns: np.ndarray,
                              lengths: np.ndarray):
        """Closed SA ranges for right-aligned-padded int patterns (the
        host twin of ops/rank_torch.backward_search, built on the sparse
        rank): returns (sp, ep) int64[Q]."""
        C = np.asarray(C, np.int64)
        q = patterns.shape[0]
        rows = np.arange(q)
        last = patterns[rows, lengths - 1].astype(np.int64)
        sp = C[last]
        ep = C[last + 1] - 1
        max_len = patterns.shape[1]
        for t in range(max_len - 1):
            idx = lengths - 2 - t
            active = (idx >= 0) & (ep >= sp)
            if not active.any():
                break
            cc = patterns[rows, np.clip(idx, 0, max_len - 1)].astype(np.int64)
            aw = np.flatnonzero(active)
            bounds = np.concatenate([sp[aw], ep[aw] + 1])
            ranks = self.rank(bounds, np.concatenate([cc[aw], cc[aw]]))
            sp[aw] = C[cc[aw]] + ranks[: aw.size]
            ep[aw] = C[cc[aw]] + ranks[aw.size:] - 1
        return sp, ep
