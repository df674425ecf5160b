"""Streaming format readers: iterate a BWT file as bounded run chunks.

Mirror of the streaming writers (streaming.py): no reader materializes the
whole file or the whole decoded text.  The reference reads every format
through fixed 1 MB buffers (PlainData/RopeData, formats.cpp:126-216,281-363);
here each format yields (syms, lens) run chunks of bounded size, maximal-run
clean across chunk seams (the trailing run of a chunk is withheld until the
next chunk proves it complete — the RunBuffer discipline, utils.h:121-142).

`read_bwt_chunks(path, fmt)` is the streaming entry point; the batch readers
in formats.py are built on top of it, so loading any format costs O(chunk)
transient memory plus the final run arrays.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

import numpy as np

from ..models.runs import RunArrays, SIGMA
from ..native import rle_decode
from ..utils.alphabet import Alphabet, create_alphabet
from . import codec
from .headers import NativeHeader, RopeHeader, SGAHeader

CHUNK_BYTES = 1 << 20  # reference buffer size (formats.cpp:129 MEGABYTE)

RunChunk = Tuple[np.ndarray, np.ndarray]


def _coalesce(fragments: Iterator[RunChunk]) -> Iterator[RunChunk]:
    """Merge run fragments across chunk seams into maximal-run-clean chunks.

    Within a fragment adjacent equal-symbol runs are summed; the trailing run
    is withheld and prepended to the next fragment so no chunk ever ends
    mid-run.
    """
    held_sym, held_len = -1, 0
    for syms, lens in fragments:
        if syms.size == 0:
            continue
        if held_len and syms[0] == held_sym:
            lens = lens.copy()
            lens[0] += held_len
            held_len = 0
        # collapse equal-symbol neighbours (fragment boundaries may split runs)
        heads = np.empty(syms.size, dtype=bool)
        heads[0] = True
        np.not_equal(syms[1:], syms[:-1], out=heads[1:])
        idx = np.flatnonzero(heads)
        if idx.size != syms.size:
            cs = np.concatenate(([0], np.cumsum(lens)))
            ends = np.concatenate((idx[1:], [syms.size]))
            lens = cs[ends] - cs[idx]
            syms = syms[idx]
        if held_len:
            syms = np.concatenate(([held_sym], syms)).astype(np.uint8)
            lens = np.concatenate(([held_len], lens))
        held_sym, held_len = int(syms[-1]), int(lens[-1])
        if syms.size > 1:
            yield syms[:-1], lens[:-1]
    if held_len:
        yield (np.array([held_sym], dtype=np.uint8),
               np.array([held_len], dtype=np.int64))


def _file_chunks(f, total: int, chunk_bytes: int) -> Iterator[np.ndarray]:
    remaining = total
    while remaining > 0:
        buf = f.read(min(chunk_bytes, remaining))
        if not buf:
            raise ValueError("file truncated: "
                             f"{remaining} payload bytes missing")
        remaining -= len(buf)
        yield np.frombuffer(buf, dtype=np.uint8)


def _values_to_fragments(chunks: Iterator[np.ndarray],
                         mapper) -> Iterator[RunChunk]:
    """Byte chunks of decoded-text values -> run fragments."""
    for values in chunks:
        comps = mapper(values)
        heads = np.empty(comps.size, dtype=bool)
        heads[0] = True
        np.not_equal(comps[1:], comps[:-1], out=heads[1:])
        idx = np.flatnonzero(heads)
        lens = np.diff(np.concatenate((idx, [comps.size])))
        yield comps[idx], lens.astype(np.int64)


def _plain_chunks(path: str, fmt_cls, chunk_bytes: int) -> Iterator[RunChunk]:
    alpha = fmt_cls._alphabet()
    c2c = alpha.char2comp

    with open(path, "rb") as f:
        if fmt_cls.framed:
            (bits,) = struct.unpack("<Q", f.read(8))
            total = bits // 8
        else:
            f.seek(0, 2)
            total = f.tell()
            f.seek(0)
        yield from _coalesce(_values_to_fragments(
            _file_chunks(f, total, chunk_bytes), lambda v: c2c[v]))


def _rope_chunks(path: str, fmt_cls, chunk_bytes: int) -> Iterator[RunChunk]:
    with open(path, "rb") as f:
        if fmt_cls.tag == "sga":
            header = SGAHeader.from_bytes(f.read(SGAHeader.SIZE))
            if not header.check():
                raise ValueError(f"{path}: invalid SGA header")
            total = header.bytes_
        else:
            header = RopeHeader.from_bytes(f.read(RopeHeader.SIZE))
            if not header.check():
                raise ValueError(f"{path}: invalid RopeBWT header")
            f.seek(0, 2)
            total = f.tell() - RopeHeader.SIZE
            f.seek(RopeHeader.SIZE)

        def fragments():
            for codes in _file_chunks(f, total, chunk_bytes):
                syms, lens = fmt_cls._decode_codes(codes)
                yield syms, lens.astype(np.int64)

        yield from _coalesce(fragments())


def _native_chunks(path: str, chunk_bytes: int) -> Iterator[RunChunk]:
    chunk_bytes -= chunk_bytes % codec.RUN_BLOCK_SIZE  # blocks self-contained
    with open(path, "rb") as f:
        header = NativeHeader.from_bytes(f.read(NativeHeader.SIZE))
        if not header.check():
            raise ValueError(f"{path}: invalid native header")
        (n_bytes,) = struct.unpack("<Q", f.read(8))

        def fragments():
            for data in _file_chunks(f, n_bytes, chunk_bytes):
                yield rle_decode(data)

        yield from _coalesce(fragments())


def read_native_tail(path: str) -> Alphabet:
    """The alphabet serialized after the native RLE payload (fmi.cpp:87-98)."""
    from . import sdsl_compat as sdsl
    from .formats import BLOCK_ARRAY_BLOCK

    with open(path, "rb") as f:
        f.seek(NativeHeader.SIZE)
        (n_bytes,) = struct.unpack("<Q", f.read(8))
        n_big = (n_bytes + BLOCK_ARRAY_BLOCK - 1) // BLOCK_ARRAY_BLOCK
        f.seek(NativeHeader.SIZE + 8 + n_big * BLOCK_ARRAY_BLOCK)
        for _c in range(SIGMA):
            sdsl.read_sd_vector(f)
            f.read(8)  # CumulativeArray m_size
        sdsl.read_sd_vector(f)  # block_boundaries
        char2comp, _ = sdsl.read_int_vector(f, 8)
        comp2char, _ = sdsl.read_int_vector(f, 8)
        C, _ = sdsl.read_int_vector(f, 64)
        (sigma,) = struct.unpack("<Q", f.read(8))
    return Alphabet(char2comp=char2comp.astype(np.uint8),
                    comp2char=comp2char.astype(np.uint8)[:sigma],
                    C=C.astype(np.uint64))


def read_bwt_chunks(path: str, fmt: str,
                    chunk_bytes: int = CHUNK_BYTES) -> Iterator[RunChunk]:
    """Stream a BWT file as maximal-run-clean (syms, lens) chunks.

    Transient memory is O(chunk_bytes); nothing decodes the whole text.
    """
    from .formats import FORMATS

    if fmt not in FORMATS:
        raise ValueError(f"invalid BWT format: {fmt}")
    fmt_cls = FORMATS[fmt]
    if fmt == "native":
        return _native_chunks(path, chunk_bytes)
    if fmt in ("sga", "ropebwt"):
        return _rope_chunks(path, fmt_cls, chunk_bytes)
    return _plain_chunks(path, fmt_cls, chunk_bytes)


def read_bwt_streaming(path: str, fmt: str,
                       chunk_bytes: int = CHUNK_BYTES):
    """Batch read built on the chunk stream: (RunArrays, counts, Alphabet).

    Peak transient memory is the run arrays plus one chunk — never the raw
    file plus the decoded text (the old readers' profile).
    """
    parts_s, parts_l = [], []
    counts = np.zeros(SIGMA, dtype=np.int64)
    for syms, lens in read_bwt_chunks(path, fmt, chunk_bytes):
        parts_s.append(syms)
        parts_l.append(lens)
        np.add.at(counts, syms, lens)
    if parts_s:
        runs = RunArrays(np.concatenate(parts_s), np.concatenate(parts_l))
    else:
        runs = RunArrays.empty()

    from .formats import FORMATS

    if fmt == "native":
        alpha = read_native_tail(path)
    else:
        # RFM stores raw comp values but its logical alphabet is still the
        # sorted order (formats.cpp:253-263) — order() covers both cases.
        base = create_alphabet(FORMATS[fmt].order())
        alpha = Alphabet.from_counts(counts, base.char2comp, base.comp2char)
    return runs, counts, alpha


def alphabet_for(fmt: str, counts: np.ndarray, path: str) -> Alphabet:
    """The Alphabet a format's batch reader would attach, from externally
    accumulated counts — lets chunk-stream consumers (e.g. the k-way fold's
    0.5 B/pos nibble loader, ops/rank_torch.pack_nibbles_chunked) skip the
    run-array materialization entirely."""
    from .formats import FORMATS

    if fmt == "native":
        return read_native_tail(path)
    base = create_alphabet(FORMATS[fmt].order())
    return Alphabet.from_counts(counts, base.char2comp, base.comp2char)
