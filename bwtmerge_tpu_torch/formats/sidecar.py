"""Read-text sidecar: the per-read text of a BWT, stored next to it.

The walk search (ops/walk_torch.py) needs B's reads as characters
from each read's end.  Our build pipeline has the reads anyway (the
reference outsources construction to ropebwt and never sees them,
paper.tex:274), so `bwt_build` emits this sidecar for free; externally
built BWTs get one from a single on-device decode (decode_creads), cached
here so every later fold/merge skips the decode.

Layout (little-endian):
  magic   u64  0x32534452544D5742  ("BWTMRDS2"; v1 "BWTMRDS1" accepted)
  R       u64  number of reads
  total   u64  total characters (sum of lengths)
  hash    u64  FNV-1a over the packed chars bytes (v2 only; corruption gate)
  lengths u32[R]
  chars   u8[(total+1)//2]  4-bit packed comp values 1..5, reads
          concatenated in BWT endmarker-rank order, low nibble first

The in-memory walk layout ([max_len, R] int8, characters from the END,
0 past each read's end) is assembled on load with vectorized numpy, tile
by tile (creads_layout).

A matching-content gate lives in models/merge.py (_creads_consistent):
the header hash proves the FILE is intact; the LF spot-walk there proves
the reads actually belong to the BWT being merged.
"""

from __future__ import annotations

import os

import numpy as np

MAGIC_V1 = 0x31534452544D5742
MAGIC = 0x32534452544D5742
LAYOUT_TILE_BYTES = 1 << 18      # characters a tile of creads_layout


def _fnv1a_packed(packed: np.ndarray) -> int:
    """FNV-1a over the packed chars bytes (reference fnv1a_hash,
    utils.h:155-176), by the native runtime."""
    from ..native import fnv1a_bytes

    return fnv1a_bytes(np.ascontiguousarray(packed, np.uint8))


def sidecar_path(bwt_path: str) -> str:
    return bwt_path + ".reads4"


def write_sidecar(path: str, lengths: np.ndarray, flat_chars: np.ndarray
                  ) -> None:
    """lengths: int array [R]; flat_chars: uint8 [total] comp values 1..5,
    reads concatenated in endmarker-rank order, each read END-LAST (plain
    text order)."""
    lengths = np.asarray(lengths, dtype=np.uint32)
    flat = np.asarray(flat_chars, dtype=np.uint8)
    if flat.size != int(lengths.sum()):
        raise ValueError("sidecar: lengths do not sum to the char count")
    pad = flat.size & 1
    if pad:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    packed = (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.array([MAGIC, lengths.size, flat.size - pad,
                  _fnv1a_packed(packed)], dtype="<u8").tofile(f)
        lengths.astype("<u4").tofile(f)
        packed.tofile(f)
    os.replace(tmp, path)


def write_sidecar_reads(path: str, reads) -> None:
    """Convenience: sidecar from a list of per-read comp arrays."""
    lengths = np.array([len(r) for r in reads], dtype=np.uint32)
    flat = (np.concatenate([np.asarray(r, np.uint8) for r in reads])
            if reads else np.zeros(0, np.uint8))
    write_sidecar(path, lengths, flat)


def read_sidecar(path: str):
    """-> (lengths uint32[R], flat uint8[total]).

    v2 files carry an FNV-1a hash of the packed chars; a mismatch (torn
    write, disk corruption, foreign file) raises ValueError so the walk
    path falls back to the trie instead of merging corrupt text."""
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype="<u8", count=3)
        if head.size != 3 or int(head[0]) not in (MAGIC, MAGIC_V1):
            raise ValueError(f"{path}: not a reads sidecar")
        want_hash = None
        if int(head[0]) == MAGIC:
            want_hash = int(np.fromfile(f, dtype="<u8", count=1)[0])
        r, total = int(head[1]), int(head[2])
        lengths = np.fromfile(f, dtype="<u4", count=r)
        packed = np.fromfile(f, dtype=np.uint8, count=(total + 1) // 2)
    if lengths.size != r or packed.size != (total + 1) // 2:
        raise ValueError(f"{path}: truncated reads sidecar")
    if want_hash is not None and _fnv1a_packed(packed) != want_hash:
        raise ValueError(f"{path}: reads sidecar hash mismatch (corrupt)")
    flat = np.empty(packed.size * 2, np.uint8)
    flat[0::2] = packed & 0xF
    flat[1::2] = packed >> 4
    return lengths, flat[:total]


def creads_layout(lengths: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """Assemble the walk layout: int8[max_len, R], row t lane r = the t-th
    character of read r FROM THE END (0 past the end).

    Reads of one length are rows of `flat` as it stands; otherwise each
    tile's reads are filled right-aligned into a zeroed [reads, max_len]
    block through a boolean mask.  Either way each tile of LAYOUT_TILE_BYTES
    is flipped and transposed into place while it is in the core's cache;
    no index array spans the characters."""
    r = int(lengths.size)
    lens = lengths.astype(np.int64)
    max_len = int(lens.max()) if r else 0
    out = np.zeros((max(max_len, 1), max(r, 1)), np.int8)
    if r == 0 or flat.size == 0:
        return out
    ends = np.cumsum(lens)
    if int(ends[-1]) != flat.size:
        raise ValueError("sidecar: lengths do not sum to the char count")
    tile = max(1, LAYOUT_TILE_BYTES // max_len)
    equal = int(lens.min()) == max_len
    cols = np.arange(max_len)
    for r0 in range(0, r, tile):
        r1 = min(r0 + tile, r)
        if equal:
            rows = flat[r0 * max_len:r1 * max_len].reshape(r1 - r0, max_len)
        else:
            n = lens[r0:r1]
            rows = np.zeros((r1 - r0, max_len), np.int8)
            rows[cols >= max_len - n[:, None]] = flat[ends[r0] - n[0]:
                                                      ends[r1 - 1]]
        out[:, r0:r1] = rows[:, ::-1].T
    return out


def load_creads(path: str) -> np.ndarray:
    lengths, flat = read_sidecar(path)
    return creads_layout(lengths, flat)
