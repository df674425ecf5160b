"""FNV-1a content hashing of a decoded BWT.

Representation-independent equality check between two BWTs, same semantics as the
reference BWT::hash() (bwt.cpp:538-549) and fnv1a_hash (utils.h:155-176): hash the
fully decoded comp-value byte sequence.

The hash is inherently sequential (64-bit multiply mixes with XOR), so the fast
path lives in the C++ runtime (native.rle_hash); this module holds the constants
and a pure-Python fallback used by tests and small inputs.
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET_BASIS = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a_bytes(data, seed: int = FNV_OFFSET_BASIS) -> int:
    """FNV-1a over a byte sequence (pure Python; use native.rle_hash for bulk)."""
    res = seed
    if isinstance(data, (bytes, bytearray)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    for b in np.asarray(data, dtype=np.uint8).tolist():
        res = ((res ^ b) * FNV_PRIME) & _MASK64
    return res


def fnv1a_runs(syms, lens, seed: int = FNV_OFFSET_BASIS) -> int:
    """FNV-1a over an RLE sequence: each run (sym, len) contributes `len` copies.

    Pure-Python fallback; O(total length). The native runtime exposes the same
    function at memory bandwidth.
    """
    res = seed
    syms = np.asarray(syms).tolist()
    lens = np.asarray(lens).tolist()
    for s, l in zip(syms, lens):
        for _ in range(l):
            res = ((res ^ s) * FNV_PRIME) & _MASK64
    return res
