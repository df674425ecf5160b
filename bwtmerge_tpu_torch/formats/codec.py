"""Reference-native RLE byte codec (ByteCode varint + Run codec).

Byte-exact with the reference encodings:
- ByteCode (support.h:160-213): LSB-first 7-bit varint, 0x80 continuation bit.
- Run (support.h:221-286): run (c, l) with l <= 41 is one byte `c + 6*(l-1)`;
  l >= 42 emits head byte `c + 6*41` then a varint of the remainder; **no run
  crosses a 64-byte block boundary** — the writer splits runs at block edges and
  caps the varint to the bytes remaining in the block. A run of exactly 42
  encodes as head byte + varint 0x00.

The Python implementations here are the specification and the test oracle; the
C++ runtime (native/src/codec.cpp) implements the same transforms at memory
bandwidth and is cross-checked byte-for-byte against these.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SIGMA = 6
MAX_RUN = 256 // SIGMA  # 42
RUN_BLOCK_SIZE = 64     # bytes; no run crosses this boundary
DATA_BITS = 7
DATA_MASK = 0x7F
NEXT_BYTE = 0x80


def encode_runs(syms, lens) -> bytes:
    """Encode runs into the reference-native RLE byte stream (Run::write).

    Accepts any run partition; the output is the deterministic stored-run
    partition the reference would produce when writing the same runs in order.
    """
    out = bytearray()
    append = out.append
    for c, length in zip(np.asarray(syms, dtype=np.int64).tolist(),
                         np.asarray(lens, dtype=np.int64).tolist()):
        while length > 0:
            if length < MAX_RUN:
                append(c + SIGMA * (length - 1))
                break
            bytes_remaining = RUN_BLOCK_SIZE - (len(out) % RUN_BLOCK_SIZE)
            basic = MAX_RUN if bytes_remaining > 1 else MAX_RUN - 1
            append(c + SIGMA * (basic - 1))
            length -= basic
            bytes_remaining -= 1
            if bytes_remaining > 0:
                ext = length
                if length.bit_length() > DATA_BITS * bytes_remaining:
                    ext = (1 << (DATA_BITS * bytes_remaining)) - 1
                v = ext
                while v > DATA_MASK:
                    append((v & DATA_MASK) | NEXT_BYTE)
                    v >>= DATA_BITS
                append(v)
                length -= ext
    return bytes(out)


def decode_runs_with_offsets(data) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """decode_runs plus the byte offset where each stored run starts."""
    syms, lens = decode_runs(data)
    # Recompute offsets by re-walking byte sizes (cheap: run count scale).
    offsets = np.zeros(syms.size, dtype=np.int64)
    buf = np.frombuffer(bytes(data), dtype=np.uint8).tolist()
    i = 0
    for r in range(syms.size):
        offsets[r] = i
        code = buf[i]
        i += 1
        if code // SIGMA + 1 >= MAX_RUN:
            while buf[i] & NEXT_BYTE:
                i += 1
            i += 1
    return syms, lens, offsets


def decode_runs(data) -> Tuple[np.ndarray, np.ndarray]:
    """Decode an RLE byte stream into stored runs (syms uint8[], lens int64[]).

    Returns the stored-run partition (adjacent runs may share a symbol when the
    writer split them at block boundaries); coalesce for maximal runs.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    syms = []
    lens = []
    i = 0
    n = buf.size
    b = buf.tolist()
    while i < n:
        code = b[i]
        i += 1
        c = code % SIGMA
        length = code // SIGMA + 1
        if length >= MAX_RUN:
            shift = 0
            ext = 0
            while True:
                byte = b[i]
                i += 1
                ext += (byte & DATA_MASK) << shift
                if not (byte & NEXT_BYTE):
                    break
                shift += DATA_BITS
            length += ext
        syms.append(c)
        lens.append(length)
    return np.array(syms, dtype=np.uint8), np.array(lens, dtype=np.int64)


def stored_runs(syms, lens) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's stored-run partition of a run sequence: encode then
    decode. Needed for byte-exact ropebwt/sga output, whose run splitting
    depends on the native stored partition (formats.cpp:313-338).

    The C++ codec does the round trip (identical bytes to the Python
    encode_runs/decode_runs loop)."""
    from ..native import rle_decode, rle_encode

    return rle_decode(rle_encode(syms, lens))


def byte_code_write(out: bytearray, value: int) -> None:
    """ByteCode::write (support.h:203-212)."""
    while value > DATA_MASK:
        out.append((value & DATA_MASK) | NEXT_BYTE)
        value >>= DATA_BITS
    out.append(value)


def byte_code_read(data, i: int) -> Tuple[int, int]:
    """ByteCode::read; returns (value, next_index) (support.h:172-184)."""
    offset = 0
    res = data[i] & DATA_MASK
    while data[i] & NEXT_BYTE:
        i += 1
        offset += DATA_BITS
        res += (data[i] & DATA_MASK) << offset
    return res, i + 1
