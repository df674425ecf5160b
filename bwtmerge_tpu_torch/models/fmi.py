"""FMI: a BWT + alphabet with LF-mapping and backward search.

Capability parity with the reference FMI (fmi.h:86-230): charRange, LF in all
its forms, find() backward search, plus hash() and pattern-count verification as
first-class features (the reference's only acceptance gates, SURVEY.md §4).

The host object owns the RunArrays; rank structures (the numpy RankIndex,
and the torch DeviceFMIndex of each device asked for) are built lazily and
invalidated on mutation.  Port of bwtmerge_tpu/models/fmi.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..kernels import resolve_device
from ..ops.rank_np import RankIndex
from ..ops.rank_torch import DeviceFMIndex
from ..utils.alphabet import Alphabet, SIGMA
from .runs import RunArrays


@dataclass
class FMI:
    runs: RunArrays
    alpha: Alphabet
    _rank: Optional[RankIndex] = field(default=None, repr=False, compare=False)
    _torch: dict = field(default_factory=dict, repr=False, compare=False)
    # read-text sidecar (formats/sidecar.py): path on disk and/or the loaded
    # walk-layout array — enables the walk search (ops/walk_torch.py)
    creads_path: Optional[str] = field(default=None, repr=False, compare=False)
    _creads: Optional[np.ndarray] = field(default=None, repr=False,
                                          compare=False)

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_runs(cls, runs: RunArrays, alpha: Optional[Alphabet] = None) -> "FMI":
        if alpha is None:
            alpha = Alphabet.from_counts(runs.counts(SIGMA))
        return cls(runs=runs, alpha=alpha)

    # -- basic properties ------------------------------------------------------

    def size(self) -> int:
        return self.runs.size()

    def sequences(self) -> int:
        return int(self.alpha.C[1] - self.alpha.C[0])

    @property
    def rank_index(self) -> RankIndex:
        if self._rank is None or self._rank.size != self.runs.size():
            self._rank = RankIndex.build(self.runs, self.alpha.sigma)
        return self._rank

    def device_index(self, device="cuda") -> DeviceFMIndex:
        """The device FM-index on `device`, built once per device (shared by
        verification and merge so each BWT uploads once per process)."""
        dev = resolve_device(device)
        idx = self._torch.get(dev)
        if idx is None or idx.size != self.size():
            idx = DeviceFMIndex.build(self.runs, self.alpha.counts(), dev)
            self._torch[dev] = idx
        return idx

    def invalidate(self) -> None:
        self._rank = None
        self._torch.clear()
        self.creads_path = None
        self._creads = None

    def creads(self) -> Optional[np.ndarray]:
        """The read-text sidecar in walk layout (int8[max_len, R], characters
        from each read's end, 0-padded), if attached or on disk; None
        otherwise.  See ops/walk_torch.py for what this unlocks."""
        if self._creads is None and self.creads_path is not None:
            import os

            from ..formats.sidecar import load_creads

            if os.path.exists(self.creads_path):
                try:
                    self._creads = load_creads(self.creads_path)
                except (ValueError, OSError) as e:
                    # a bad sidecar must never break a merge: warn, and the
                    # merge takes the route of a B without one
                    import sys

                    print(f"ignoring unreadable reads sidecar: {e}",
                          file=sys.stderr)
                    self.creads_path = None
        return self._creads

    def attach_creads(self, creads: np.ndarray) -> None:
        self._creads = creads

    # -- queries ---------------------------------------------------------------

    def char_range(self, comp: int) -> Tuple[int, int]:
        return self.alpha.char_range(comp)

    def LF(self, positions, comp) -> np.ndarray:
        """LF(i, c) = C[c] + rank(i, c), batched (utils.h:343-348)."""
        comp = np.asarray(comp, dtype=np.int64)
        return self.alpha.C.astype(np.int64)[comp] + self.rank_index.rank(positions, comp)

    def LF_all(self, positions) -> np.ndarray:
        """LF(i, c) for every comp value at once: int64[Q, sigma] (fmi.h:165-169)."""
        return self.alpha.C[: self.alpha.sigma].astype(np.int64)[None, :] + \
            self.rank_index.ranks_all(positions)

    def LF_step(self, positions) -> Tuple[np.ndarray, np.ndarray]:
        """(LF(i), BWT[i]) batched (utils.h:335-341)."""
        rnk, sym = self.rank_index.inverse_select(positions)
        return self.alpha.C.astype(np.int64)[sym] + rnk, sym

    def psi(self, positions) -> np.ndarray:
        """Psi(i): inverse of LF via select (utils.h:357-363), batched.

        For i in [C[c], C[c+1]): Psi(i) = select(i - C[c] + 1, c).
        """
        i = np.asarray(positions, dtype=np.int64)
        C = self.alpha.C.astype(np.int64)
        comp = np.searchsorted(C, i, side="right") - 1
        out = np.empty(i.shape, dtype=np.int64)
        for c in np.unique(comp):
            mask = comp == c
            out[mask] = self.rank_index.select(i[mask] - C[c] + 1, int(c))
        return out

    def extract(self, first: int, last: int) -> np.ndarray:
        """Decode BWT[first..last] (closed range; BWT::extract bwt.h:134-164)."""
        return self.rank_index.access(np.arange(first, last + 1, dtype=np.int64))

    def find(self, pattern) -> Tuple[int, int]:
        """Backward search; returns the closed SA range (fmi.h:195-209).

        `pattern` may be a str/bytes of characters or an array of comp values.
        """
        comps = self._to_comps(pattern)
        if comps.size == 0:
            return (0, self.size() - 1)
        sp, ep = self.char_range(int(comps[-1]))
        for c in comps[:-1][::-1]:
            if ep < sp:
                break
            res = self.LF(np.array([sp, ep + 1]), int(c))
            sp, ep = int(res[0]), int(res[1]) - 1
        return (sp, ep)

    def count(self, pattern) -> int:
        sp, ep = self.find(pattern)
        return max(0, ep - sp + 1)

    def batch_count(self, patterns: Sequence) -> np.ndarray:
        """Vectorized backward search over a whole pattern batch — the host
        analog of the reference's ParallelLoop over patterns
        (bwt_merge.cpp:276-279): one rank call per character position for
        ALL patterns at once instead of a Python loop per pattern."""
        comps = [self._to_comps(p) for p in patterns]
        if not comps:
            return np.zeros(0, dtype=np.int64)
        q = len(comps)
        max_len = max((c.size for c in comps), default=0)
        if max_len == 0:
            return np.full(q, self.size(), dtype=np.int64)
        pat = np.zeros((q, max_len), dtype=np.int64)
        lens = np.zeros(q, dtype=np.int64)
        for j, c in enumerate(comps):
            pat[j, : c.size] = c
            lens[j] = c.size
        C = self.alpha.C.astype(np.int64)
        rows = np.arange(q)
        # empty patterns count every suffix (find() semantics)
        empty = lens == 0
        safe_last = np.where(empty, 0, pat[rows, np.maximum(lens - 1, 0)])
        sp = np.where(empty, 0, C[safe_last])
        ep = np.where(empty, self.size() - 1, C[safe_last + 1] - 1)
        rank = self.rank_index
        for t in range(max_len - 1):
            idx = lens - 2 - t
            active = (idx >= 0) & (ep >= sp)
            if not active.any():
                break
            c = pat[rows, np.clip(idx, 0, max_len - 1)]
            bounds = np.concatenate([np.where(active, sp, 0),
                                     np.where(active, ep + 1, 0)])
            ranks = rank.rank(bounds, np.concatenate([c, c]))
            sp = np.where(active, C[c] + ranks[:q], sp)
            ep = np.where(active, C[c] + ranks[q:] - 1, ep)
        return np.maximum(0, ep - sp + 1)

    def _to_comps(self, pattern) -> np.ndarray:
        if isinstance(pattern, str):
            pattern = pattern.encode()
        if isinstance(pattern, (bytes, bytearray)):
            chars = np.frombuffer(bytes(pattern), dtype=np.uint8)
            return self.alpha.char2comp[chars].astype(np.int64)
        return np.asarray(pattern, dtype=np.int64)

    # -- extraction / verification ---------------------------------------------

    def extract_sequence(self, seq_rank: int) -> np.ndarray:
        """Recover sequence `seq_rank` (comp values, reversed-walk via LF)."""
        out = []
        pos = seq_rank  # endmarker row of that sequence
        while True:
            lf, sym = self.LF_step(np.array([pos]))
            if int(sym[0]) == 0:
                break
            out.append(int(sym[0]))
            pos = int(lf[0])
        return np.array(out[::-1], dtype=np.int64)

    def extract_all(self) -> list:
        """Recover EVERY sequence with lockstep batched LF walks.

        One vectorized inverse_select per depth for all m sequences at once
        instead of m Python-level walks (the batched analog of the per-row
        extract loop, bwt.h:134-164).  A finished walk parks on its endmarker
        row, where LF_step keeps yielding comp 0, so the loop ends when every
        lane is parked.  Returns a list of comp arrays in sequence-rank order.
        """
        m = self.sequences()
        if m == 0:
            return []
        pos = np.arange(m, dtype=np.int64)
        cols = []
        while True:
            lf, sym = self.LF_step(pos)
            if not (sym != 0).any():
                break
            cols.append(sym.astype(np.uint8))
            pos = np.where(sym != 0, lf, pos)
        if not cols:
            return [np.zeros(0, dtype=np.int64) for _ in range(m)]
        rev = np.stack(cols, axis=1)  # [m, max_len] reversed reads, 0 tail
        lens = (rev != 0).sum(axis=1)
        return [rev[i, : lens[i]][::-1].astype(np.int64) for i in range(m)]

    def hash(self) -> int:
        """FNV-1a over the decoded BWT (bwt.cpp:538-549), by the native
        runtime."""
        from ..native import rle_hash

        return rle_hash(self.runs.syms, self.runs.lens)

    def verify(self, patterns: Iterable) -> np.ndarray:
        """Per-pattern occurrence counts, the -v invariant's building block
        (bwt_merge.cpp:240-285)."""
        return self.batch_count(list(patterns))


# -- runtime format dispatch (reference fmi.cpp:373-447) ---------------------------


def load_fmi(path: str, fmt: str = "native") -> FMI:
    """Load a BWT file in any registered format into an FMI; the read-text
    sidecar path next to it is kept for the walk search."""
    from ..formats import read_bwt

    runs, _counts, alpha = read_bwt(path, fmt)
    from ..formats.sidecar import sidecar_path

    return FMI(runs=runs, alpha=alpha, creads_path=sidecar_path(path))


def serialize_fmi(fmi: FMI, path: str, fmt: str = "native") -> None:
    """Write an FMI in any registered format.

    Warns (like FMI::serialize, fmi.h:114-124) when the index's alphabet
    order is incompatible with the target format.
    """
    import sys

    from ..formats import FORMATS, write_bwt
    from ..utils.alphabet import compatible, identify_alphabet

    fmt_order = FORMATS[fmt].order()
    if not compatible(fmi.alpha, fmt_order):
        print(f"serialize_fmi: alphabet order {identify_alphabet(fmi.alpha).name} "
              f"is incompatible with format '{fmt}'", file=sys.stderr)
    write_bwt(path, fmt, fmi.runs, fmi.alpha,
              sequences=fmi.sequences(), bases=fmi.size())
