"""Host-side run-length-encoded BWT representation.

The canonical in-memory form of a BWT in this framework is a pair of flat numpy
arrays (syms: uint8, lens: int64) of MAXIMAL runs — the vector analog of the
reference's RLE byte stream in a BlockArray (support.h:90-150, 221-286). All
format readers produce RunArrays; all writers and the device index build
consume them. Unlike the reference's byte stream, this layout uploads directly
to device memory and vectorizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SIGMA = 6


@dataclass
class RunArrays:
    """Maximal-run RLE sequence over comp alphabet [0, SIGMA)."""

    syms: np.ndarray  # uint8[R]
    lens: np.ndarray  # int64[R]

    def __post_init__(self) -> None:
        self.syms = np.asarray(self.syms, dtype=np.uint8)
        self.lens = np.asarray(self.lens, dtype=np.int64)
        if self.syms.shape != self.lens.shape:
            raise ValueError("syms and lens must have the same shape")

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_values(cls, values) -> "RunArrays":
        """RLE-encode a plain comp-value sequence (vectorized RunBuffer,
        reference utils.h:121-142)."""
        values = np.asarray(values, dtype=np.uint8)
        if values.size == 0:
            return cls(np.zeros(0, np.uint8), np.zeros(0, np.int64))
        boundaries = np.flatnonzero(values[1:] != values[:-1]) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [values.size]))
        return cls(values[starts], (ends - starts).astype(np.int64))

    @classmethod
    def from_runs(cls, syms, lens) -> "RunArrays":
        """Build from possibly non-maximal runs; coalesces adjacent equal syms
        and drops zero-length runs."""
        return cls(np.asarray(syms, dtype=np.uint8), np.asarray(lens, dtype=np.int64)).coalesced()

    @classmethod
    def empty(cls) -> "RunArrays":
        return cls(np.zeros(0, np.uint8), np.zeros(0, np.int64))

    # -- basic properties -----------------------------------------------------

    @property
    def n_runs(self) -> int:
        return int(self.syms.size)

    def size(self) -> int:
        """Total sequence length (bases incl. endmarkers)."""
        return int(self.lens.sum())

    def counts(self, sigma: int = SIGMA) -> np.ndarray:
        """Per-comp symbol counts (reference BWT::characterCounts,
        bwt.cpp:525-536), summed exactly in one native pass: int64[sigma],
        longer where a symbol lies past it (as np.bincount's minlength)."""
        from ..native import run_sym_sums

        return run_sym_sums(self.syms, self.lens, sigma)

    def sequences(self) -> int:
        """Number of sequences = count of endmarkers (comp 0)."""
        return int(self.lens[self.syms == 0].sum())

    # -- transforms -----------------------------------------------------------

    def coalesced(self) -> "RunArrays":
        """Merge adjacent runs with equal symbols; drop zero-length runs."""
        keep = self.lens > 0
        syms, lens = self.syms[keep], self.lens[keep]
        if syms.size == 0:
            return RunArrays.empty()
        new_run = np.empty(syms.size, dtype=bool)
        new_run[0] = True
        np.not_equal(syms[1:], syms[:-1], out=new_run[1:])
        idx = np.cumsum(new_run) - 1
        out_syms = syms[new_run]
        out_lens = np.zeros(out_syms.size, dtype=np.int64)
        np.add.at(out_lens, idx, lens)
        return RunArrays(out_syms, out_lens)

    def is_maximal(self) -> bool:
        if self.n_runs == 0:
            return True
        return bool(np.all(self.lens > 0) and np.all(self.syms[1:] != self.syms[:-1]))

    def decode(self) -> np.ndarray:
        """Decode to the plain comp-value sequence (uint8[size])."""
        return np.repeat(self.syms, self.lens)

    def iter_chunks(self, max_positions: int):
        """Yield (syms, lens) run chunks each covering <= max_positions text
        positions (long runs are split at chunk boundaries).  Lets writers
        and index builds decode bounded windows instead of the whole text."""
        cum = np.concatenate(([0], np.cumsum(self.lens)))
        total = int(cum[-1])
        pos = 0
        while pos < total:
            end = min(pos + max_positions, total)
            i0 = int(np.searchsorted(cum, pos, side="right")) - 1
            i1 = int(np.searchsorted(cum, end, side="left"))
            syms = self.syms[i0:i1]
            lens = self.lens[i0:i1].copy()
            lens[0] -= pos - cum[i0]
            lens[-1] -= cum[i1] - end
            yield syms, lens
            pos = end

    def run_starts(self) -> np.ndarray:
        """Exclusive prefix sum of lens: text position where each run starts."""
        starts = np.zeros(self.n_runs + 1, dtype=np.int64)
        np.cumsum(self.lens, out=starts[1:])
        return starts[:-1]

    # -- equality / hashing ---------------------------------------------------

    def __eq__(self, other: object) -> bool:
        # by value, with any run array (syms, lens) that can coalesce
        if not (hasattr(other, "coalesced") and hasattr(other, "syms")):
            return NotImplemented
        a, b = self.coalesced(), other.coalesced()
        return np.array_equal(a.syms, b.syms) and np.array_equal(a.lens, b.lens)
