"""SDSL-compatible serialization: int_vector, bit_vector, sd_vector,
select_support_mcl.

The reference's native format embeds SDSL-serialized structures
(BWT::serialize, bwt.cpp:111-130; Alphabet::serialize, support.cpp:160-171).
This module implements that binary layout from the SDSL-lite format:

- int_vector<w> (fixed width): u64 size-in-bits header, then data packed
  LSB-first into little-endian u64 words, padded to a whole number of words.
- int_vector<0> (dynamic width): u64 size-in-bits, u8 width, then data words.
- bit_vector = int_vector<1>.
- sd_vector<>: u64 m_size, u8 m_wl, m_low (int_vector<0>, width m_wl),
  m_high (bit_vector), m_high_1_select, m_high_0_select (select_support_mcl
  over m_high for 1- and 0-bits).
- rank_support_sd / select_support_sd: serialize zero bytes.
- select_support_mcl<b,1>: u64 arg_cnt; if nonzero: superblock positions
  (int_vector<0>, one entry per 4096 args, width ceil(log2 of word-padded
  bit-size)), a mini-or-long indicator bit_vector (empty when no long blocks
  exist), then per superblock either a miniblock (int_vector<0> of 64 relative
  positions of every 64th arg) or a long superblock (absolute positions of all
  args) — long iff the superblock spans more than log^4(n) bits.

The numbers stored (not just the framing) follow SDSL's construction rules so
files are interchangeable with SDSL-built tools; widths of the mcl blocks are
the one place the upstream code has freedom, and they are parsed (never
assumed) on load. Pure-Python/numpy here; mirrored in C++ (native/src) for
bulk IO.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Tuple

import numpy as np


def bits_hi(x: int) -> int:
    """Index of the highest set bit; 0 for x == 0 (sdsl bits::hi)."""
    return x.bit_length() - 1 if x > 0 else 0


# -- bit packing ---------------------------------------------------------------


def pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """Pack integers into u64 words, LSB-first (sdsl int_vector layout)."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.size
    total_bits = n * width
    words = np.zeros((total_bits + 63) // 64, dtype=np.uint64)
    if n == 0 or width == 0:
        return words
    if width == 64:
        return values.copy()
    mask = np.uint64((1 << width) - 1)
    values = values & mask
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    wi = (pos >> np.uint64(6)).astype(np.int64)
    off = pos & np.uint64(63)
    np.bitwise_or.at(words, wi, values << off)
    spans = (off.astype(np.int64) + width) > 64
    if spans.any():
        np.bitwise_or.at(words, wi[spans] + 1,
                         values[spans] >> (np.uint64(64) - off[spans]))
    return words


def unpack_bits(words: np.ndarray, width: int, count: int) -> np.ndarray:
    """Inverse of pack_bits."""
    words = np.asarray(words, dtype=np.uint64)
    if count == 0 or width == 0:
        return np.zeros(count, dtype=np.uint64)
    if width == 64:
        return words[:count].copy()
    pos = np.arange(count, dtype=np.uint64) * np.uint64(width)
    wi = (pos >> np.uint64(6)).astype(np.int64)
    off = pos & np.uint64(63)
    lo = words[wi] >> off
    spans = (off.astype(np.int64) + width) > 64
    hi = np.zeros(count, dtype=np.uint64)
    if spans.any():
        hi[spans] = words[wi[spans] + 1] << (np.uint64(64) - off[spans])
    mask = np.uint64((1 << width) - 1)
    return (lo | hi) & mask


# -- int_vector ----------------------------------------------------------------


def write_int_vector(out: BinaryIO, values: np.ndarray, width: int,
                     fixed_width: bool) -> None:
    values = np.asarray(values, dtype=np.uint64)
    bits = values.size * width
    out.write(struct.pack("<Q", bits))
    if not fixed_width:
        out.write(struct.pack("<B", width))
    out.write(pack_bits(values, width).tobytes())


def read_int_vector(inp: BinaryIO, width: int | None) -> Tuple[np.ndarray, int]:
    """Read an int_vector; width=None means dynamic (int_vector<0>).
    Returns (values, width)."""
    (bits,) = struct.unpack("<Q", inp.read(8))
    if width is None:
        (width,) = struct.unpack("<B", inp.read(1))
    count = bits // width if width else 0
    n_words = (bits + 63) // 64
    words = np.frombuffer(inp.read(8 * n_words), dtype=np.uint64)
    return unpack_bits(words, width, count), width


def write_bit_vector(out: BinaryIO, bits: np.ndarray) -> None:
    """bit_vector = int_vector<1>; `bits` is a 0/1 uint8 array."""
    bits = np.asarray(bits, dtype=np.uint8)
    out.write(struct.pack("<Q", bits.size))
    n_words = (bits.size + 63) // 64
    padded = np.zeros(n_words * 64, dtype=np.uint8)
    padded[: bits.size] = bits
    # LSB-first within each byte, little-endian bytes within each word.
    byte_vals = (padded.reshape(-1, 8) * (1 << np.arange(8, dtype=np.uint16))).sum(axis=1).astype(np.uint8)
    out.write(byte_vals.tobytes())


def read_bit_vector(inp: BinaryIO) -> np.ndarray:
    (bits,) = struct.unpack("<Q", inp.read(8))
    n_words = (bits + 63) // 64
    raw = np.frombuffer(inp.read(8 * n_words), dtype=np.uint8)
    out = np.unpackbits(raw, bitorder="little")
    return out[:bits]


# -- select_support_mcl ----------------------------------------------------------

SUPER_BLOCK = 4096


@dataclass
class SelectMcl:
    """Constructed select_support_mcl structure (for serialization only)."""

    arg_cnt: int
    logn: int
    superblock: np.ndarray          # absolute position of arg #(4096*i)
    miniblocks: list                # per sb: np.ndarray of 64 rel positions or None
    longsuperblocks: list           # per sb: np.ndarray of absolute positions or None
    has_long: bool


def build_select_mcl(bit_positions: np.ndarray, vector_bit_size: int) -> SelectMcl:
    """Build the mcl structure over the given sorted positions of args
    (1-bits or 0-bits of the supported bit_vector)."""
    arg_cnt = int(bit_positions.size)
    padded = ((vector_bit_size + 63) >> 6) << 6
    logn = bits_hi(padded) + 1
    logn4 = (logn * logn) * (logn * logn)
    sb = (arg_cnt + SUPER_BLOCK - 1) // SUPER_BLOCK
    superblock = np.zeros(sb, dtype=np.uint64)
    miniblocks: list = [None] * sb
    longsb: list = [None] * sb
    has_long = False
    for i in range(sb):
        lo = i * SUPER_BLOCK
        hi = min(lo + SUPER_BLOCK, arg_cnt)
        args = bit_positions[lo:hi]
        first = int(args[0])
        last = int(args[-1])
        superblock[i] = first
        pos_diff = last - first
        if pos_diff > logn4:
            has_long = True
            width = bits_hi(last) + 1
            vals = np.zeros(SUPER_BLOCK, dtype=np.uint64)
            vals[: args.size] = args
            longsb[i] = (vals, width)
        else:
            width = bits_hi(pos_diff) + 1
            vals = np.zeros(64, dtype=np.uint64)
            idx = np.arange(0, args.size, 64)
            vals[: idx.size] = args[idx] - first
            miniblocks[i] = (vals, width)
    return SelectMcl(arg_cnt, logn, superblock, miniblocks, longsb, has_long)


def write_select_mcl(out: BinaryIO, mcl: SelectMcl) -> None:
    out.write(struct.pack("<Q", mcl.arg_cnt))
    if mcl.arg_cnt == 0:
        return
    write_int_vector(out, mcl.superblock, mcl.logn, fixed_width=False)
    sb = len(mcl.miniblocks)
    if mcl.has_long:
        indicator = np.array([1 if mcl.miniblocks[i] is not None else 0 for i in range(sb)],
                             dtype=np.uint8)
        write_bit_vector(out, indicator)
        for i in range(sb):
            if indicator[i]:
                vals, width = mcl.miniblocks[i]
                write_int_vector(out, vals, width, fixed_width=False)
            else:
                vals, width = mcl.longsuperblocks[i]
                write_int_vector(out, vals, width, fixed_width=False)
    else:
        write_bit_vector(out, np.zeros(0, dtype=np.uint8))
        for i in range(sb):
            vals, width = mcl.miniblocks[i]
            write_int_vector(out, vals, width, fixed_width=False)


def read_select_mcl(inp: BinaryIO) -> int:
    """Parse (skip) a serialized select_support_mcl; returns arg_cnt."""
    (arg_cnt,) = struct.unpack("<Q", inp.read(8))
    if arg_cnt == 0:
        return 0
    read_int_vector(inp, None)                     # superblock
    indicator = read_bit_vector(inp)               # mini_or_long
    sb = (arg_cnt + SUPER_BLOCK - 1) // SUPER_BLOCK
    for _i in range(sb):
        read_int_vector(inp, None)                 # mini or long block (self-describing)
    return arg_cnt


# -- sd_vector -------------------------------------------------------------------


def sd_vector_params(size: int, ones: int) -> int:
    """The low-bits width wl chosen by sdsl's sd_vector construction (sd_vector.hpp)."""
    logm = bits_hi(ones) + 1
    logn = bits_hi(size) + 1
    if logm == logn:
        logm -= 1
    return logn - logm


def write_sd_vector(out: BinaryIO, positions: np.ndarray, size: int) -> None:
    """Serialize an sd_vector with 1-bits at `positions` (sorted) and total
    length `size`, byte-compatible with sdsl::sd_vector<> built via
    sdsl's sd_vector construction."""
    positions = np.asarray(positions, dtype=np.uint64)
    ones = positions.size
    wl = sd_vector_params(size, ones)
    out.write(struct.pack("<Q", size))
    out.write(struct.pack("<B", wl))
    low = positions & np.uint64((1 << wl) - 1) if wl < 64 else positions
    write_int_vector(out, low, wl, fixed_width=False)

    high_len = ones + (size >> wl) + 1
    high_pos = (positions >> np.uint64(wl)).astype(np.int64) + np.arange(ones, dtype=np.int64)
    high = np.zeros(high_len, dtype=np.uint8)
    high[high_pos] = 1
    write_bit_vector(out, high)

    ones_pos = high_pos.astype(np.uint64)
    zeros_pos = np.flatnonzero(high == 0).astype(np.uint64)
    write_select_mcl(out, build_select_mcl(ones_pos, high_len))
    write_select_mcl(out, build_select_mcl(zeros_pos, high_len))


def read_sd_vector(inp: BinaryIO) -> Tuple[np.ndarray, int]:
    """Parse an sd_vector; returns (positions of 1-bits, size)."""
    (size,) = struct.unpack("<Q", inp.read(8))
    (wl,) = struct.unpack("<B", inp.read(1))
    low, _ = read_int_vector(inp, None)
    high = read_bit_vector(inp)
    read_select_mcl(inp)
    read_select_mcl(inp)
    ones_idx = np.flatnonzero(high)
    ranks = np.arange(ones_idx.size, dtype=np.uint64)
    positions = ((ones_idx.astype(np.uint64) - ranks) << np.uint64(wl)) | low[: ones_idx.size]
    return positions, size
