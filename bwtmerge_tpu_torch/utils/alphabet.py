"""Contiguous comp alphabets and alphabetic orders.

Capability parity with the reference Alphabet (support.h:41-86, support.cpp:34-225)
and the alphabet-order registry (formats.h:35-40, formats.cpp:34-99):

- comp values are a contiguous byte alphabet [0, sigma); char2comp / comp2char are
  256-entry / sigma-entry maps; C is the cumulative count array C[sigma + 1].
- Default DNA order is ``$ACGTN`` (a/A -> 1 ... n/N -> 5); the SORTED order swaps
  T and N so comp order equals character order (``$ACGNT``).

Stored as numpy arrays so the maps upload directly to device memory.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

MAX_SIGMA = 256
SIGMA = 6  # DNA alphabet {$, A, C, G, T, N}


def _default_char2comp() -> np.ndarray:
    """256-entry map: \\0 and '$' are endmarkers; ACGT/acgt map to 1..4; rest to N."""
    m = np.full(MAX_SIGMA, 5, dtype=np.uint8)
    m[0] = 0
    m[ord("$")] = 0
    for i, c in enumerate("ACGT"):
        m[ord(c)] = i + 1
        m[ord(c.lower())] = i + 1
    return m


DEFAULT_CHAR2COMP = _default_char2comp()
DEFAULT_COMP2CHAR = np.frombuffer(b"$ACGTN", dtype=np.uint8).copy()


class AlphabeticOrder(enum.IntEnum):
    """Reference AlphabeticOrder (formats.h:35)."""

    DEFAULT = 0   # $ACGTN
    SORTED = 1    # $ACGNT (comp order == char order)
    ANY = 254
    UNKNOWN = 255


@dataclass
class Alphabet:
    """comp alphabet with cumulative counts.

    C[c] = number of BWT symbols with comp value < c; C[sigma] = total size.
    """

    char2comp: np.ndarray = field(default_factory=lambda: DEFAULT_CHAR2COMP.copy())
    comp2char: np.ndarray = field(default_factory=lambda: DEFAULT_COMP2CHAR.copy())
    C: np.ndarray = field(default_factory=lambda: np.zeros(SIGMA + 1, dtype=np.uint64))

    @property
    def sigma(self) -> int:
        return len(self.comp2char)

    @classmethod
    def from_counts(cls, counts, char2comp=None, comp2char=None) -> "Alphabet":
        """Build from per-comp symbol counts (reference support.cpp:84-91)."""
        c2c = DEFAULT_CHAR2COMP.copy() if char2comp is None else np.asarray(char2comp, dtype=np.uint8).copy()
        cc = DEFAULT_COMP2CHAR.copy() if comp2char is None else np.asarray(comp2char, dtype=np.uint8).copy()
        counts = np.asarray(counts, dtype=np.uint64)
        C = np.zeros(len(cc) + 1, dtype=np.uint64)
        np.cumsum(counts[: len(cc)], out=C[1 : len(counts) + 1])
        return cls(char2comp=c2c, comp2char=cc, C=C)

    @classmethod
    def identity(cls, sigma: int) -> "Alphabet":
        """Alphabet of given size where char values equal comp values
        (reference support.cpp:93-113; used by the RFM format)."""
        if sigma == 0 or sigma > MAX_SIGMA:
            raise ValueError(f"invalid alphabet size: {sigma}")
        char2comp = np.zeros(MAX_SIGMA, dtype=np.uint8)
        char2comp[:sigma] = np.arange(sigma, dtype=np.uint8)
        comp2char = np.arange(sigma, dtype=np.uint8)
        return cls(char2comp=char2comp, comp2char=comp2char,
                   C=np.zeros(sigma + 1, dtype=np.uint64))

    def sorted(self) -> bool:
        """comp order == character order (reference support.cpp:182-190)."""
        cc = self.comp2char
        return bool(np.all(cc[:-1] < cc[1:])) if len(cc) > 1 else True

    def counts(self) -> np.ndarray:
        return np.diff(self.C).astype(np.uint64)

    def size(self) -> int:
        return int(self.C[-1])

    def char_range(self, comp: int):
        """Closed SA range of suffixes starting with comp (utils.h:318-323)."""
        return (int(self.C[comp]), int(self.C[comp + 1]) - 1)

    def has_char(self, comp: int) -> bool:
        return self.C[comp + 1] > self.C[comp]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Alphabet):
            return NotImplemented
        return (
            self.sigma == other.sigma
            and np.array_equal(self.char2comp, other.char2comp)
            and np.array_equal(self.comp2char, other.comp2char)
        )

    def __repr__(self) -> str:
        parts = ", ".join(
            f"({chr(int(self.comp2char[i]))}, {self.char_range(i)})" for i in range(self.sigma)
        )
        return f"[ {parts} ]"


def create_alphabet(order: AlphabeticOrder) -> Alphabet:
    """Alphabet for a given order (reference formats.cpp:34-53)."""
    alpha = Alphabet()
    if order == AlphabeticOrder.SORTED:
        alpha.comp2char[4], alpha.comp2char[5] = alpha.comp2char[5], alpha.comp2char[4]
        for a, b in (("N", "T"), ("n", "t")):
            ai, bi = ord(a), ord(b)
            alpha.char2comp[ai], alpha.char2comp[bi] = alpha.char2comp[bi], alpha.char2comp[ai]
    return alpha


def identify_alphabet(alpha: Alphabet) -> AlphabeticOrder:
    """reference formats.cpp:55-64."""
    if alpha.sorted():
        return AlphabeticOrder.SORTED
    if alpha == Alphabet():
        return AlphabeticOrder.DEFAULT
    return AlphabeticOrder.UNKNOWN


def alphabet_name(order: AlphabeticOrder) -> str:
    return {
        AlphabeticOrder.DEFAULT: "default",
        AlphabeticOrder.SORTED: "sorted",
        AlphabeticOrder.ANY: "any",
    }.get(order, "unknown")


def compatible(alpha: Alphabet, order: AlphabeticOrder) -> bool:
    """reference formats.cpp:83-99."""
    if order == AlphabeticOrder.DEFAULT:
        return alpha == Alphabet()
    if order == AlphabeticOrder.SORTED:
        return alpha.sorted()
    return order == AlphabeticOrder.ANY
