"""Streaming format writers: serialize a BWT from run chunks, never holding
the whole sequence in memory.

The batch writers (formats.py) take a full RunArrays; at terabase scale the
merged output must flow straight from the streaming interleave
(native interleave_stream_chunks) to disk.  State carried across chunks:

  * the 64-byte-block RLE encoder offset (the Run codec's block-splitting
    rule is position-dependent, support.h:256-282)
  * per-RLE-block sample accumulators for the native format's rank tables
    (BWT::build's single scan, bwt.cpp:477-512, incrementalized): text
    position and per-char cumulative counts at each 64-byte block end
  * cumulative char counts / sequence counts for the headers

Chunk encoding runs in the native C++ kernels (native/src/writer.cpp) into
persistent buffers owned by the writer and reused across chunks:
fresh per-chunk numpy temporaries — the one-hot/cumsum sample
tables and the stored-run split — used to dominate the whole merge phase through
their first-touch page faults.

Headers that carry totals (NativeHeader, SGAHeader) are back-patched with a
seek on close, so targets must be real seekable files.  Output block tables
cost O(bytes/64) memory; everything else is O(chunk).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from ..models.runs import SIGMA
from ..utils.alphabet import Alphabet, identify_alphabet
from . import sdsl_compat as sdsl
from .formats import BLOCK_ARRAY_BLOCK
from .headers import NativeHeader, SGAHeader


def _grown(arr: np.ndarray, need: int) -> np.ndarray:
    """Persistent-buffer growth: at least double so growth amortizes."""
    if arr.size >= need:
        return arr
    return np.empty(max(need, arr.size * 2), dtype=arr.dtype)


class StreamingNativeWriter:
    """Chunked writer for the native format (byte-identical to
    NativeFormat.write for the same run stream)."""

    def __init__(self, path: str, alpha: Alphabet):
        self.alpha = alpha
        self.f = open(path, "wb")
        self.f.write(b"\x00" * (NativeHeader.SIZE + 8))  # header + u64 n_bytes
        # {rle_byte_offset, text_pos, counts[SIGMA]} — the C++ kernel's state
        self._state = np.zeros(2 + SIGMA, dtype=np.int64)
        # persistent per-chunk buffers (grown on demand, reused across chunks)
        self._rle = np.empty(1 << 20, dtype=np.uint8)
        self._blk_id = np.empty(1 << 15, dtype=np.int64)
        self._blk_end = np.empty(1 << 15, dtype=np.int64)
        self._blk_cc = np.empty((1 << 15) * SIGMA, dtype=np.int64)
        # finalized per-block samples
        self._block_end_pos: List[np.ndarray] = []
        self._block_char_cum: List[np.ndarray] = []
        # the trailing (possibly still open) block's current stats
        self._open_block = None  # (block_idx, end_pos, char_cum[SIGMA])
        self._closed = False

    @property
    def n_bytes(self) -> int:
        return int(self._state[0])

    @property
    def text_pos(self) -> int:
        return int(self._state[1])

    @property
    def char_counts(self) -> np.ndarray:
        return self._state[2:].copy()

    @property
    def sequences(self) -> int:
        return int(self._state[2])

    def write_chunk(self, syms: np.ndarray, lens: np.ndarray) -> None:
        """Append a run chunk.  Adjacent chunks must not need coalescing
        (interleave_stream_chunks guarantees maximal runs across chunks)."""
        if syms.size == 0:
            return
        from ..native import native_stream_chunk

        prev_bytes = int(self._state[0])
        while True:
            rows = native_stream_chunk(syms, lens, self._state, self._rle,
                                       self._blk_id, self._blk_end,
                                       self._blk_cc)
            if rows != -2:
                break
            # grow: RLE bound ~2 B/run + varints; block rows ~bytes/64
            est_bytes = (2 * syms.size
                         + int(np.sum(lens, dtype=np.int64)) // 41 + 1024)
            self._rle = _grown(self._rle, max(2 * self._rle.size, est_bytes))
            est_rows = est_bytes // 64 + syms.size // 32 + 1024
            self._blk_id = _grown(self._blk_id, est_rows)
            self._blk_end = _grown(self._blk_end, est_rows)
            self._blk_cc = _grown(self._blk_cc, est_rows * SIGMA)
        if rows < 0:
            raise RuntimeError(f"native_stream_chunk failed (code {rows})")

        self.f.write(self._rle[: int(self._state[0]) - prev_bytes])

        blk_ids = self._blk_id[:rows]
        blk_end = self._blk_end[:rows]
        blk_cc = self._blk_cc[: rows * SIGMA].reshape(rows, SIGMA)

        if self._open_block is not None and blk_ids[0] == self._open_block[0]:
            pass  # first row updates/extends the open block — just use it
        elif self._open_block is not None:
            # the open block closed exactly at the previous chunk boundary
            ob, oe, occ_ = self._open_block
            self._block_end_pos.append(np.array([oe]))
            self._block_char_cum.append(occ_[None, :])
        # all rows except the final one are closed blocks
        if rows > 1:
            self._block_end_pos.append(blk_end[:-1].copy())
            self._block_char_cum.append(blk_cc[:-1].copy())
        self._open_block = (int(blk_ids[-1]), int(blk_end[-1]),
                            blk_cc[-1].copy())

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._open_block is not None:
            _, oe, occ_ = self._open_block
            self._block_end_pos.append(np.array([oe]))
            self._block_char_cum.append(occ_[None, :])

        block_end_pos = (np.concatenate(self._block_end_pos)
                         if self._block_end_pos else np.zeros(0, np.int64))
        block_char_cum = (np.concatenate(self._block_char_cum)
                          if self._block_char_cum else np.zeros((0, SIGMA), np.int64))
        write_native_tail(self.f, self.n_bytes, block_end_pos, block_char_cum,
                          self.char_counts, self.alpha)
        self.f.close()


def write_native_tail(f, n_bytes: int, block_end_pos: np.ndarray,
                      block_char_cum: np.ndarray, char_counts: np.ndarray,
                      alpha_maps: Alphabet) -> None:
    """Finish a native file whose RLE bytes are already written: 8 MB
    BlockArray padding, per-char sample sd_vectors, block boundaries,
    alphabet, and the back-patched header.  `f` must be seekable and
    positioned after the last RLE byte; `alpha_maps` supplies the char
    mappings (C is re-derived from the streamed counts)."""
    # BlockArray zero padding to 8 MB blocks
    n_big = (n_bytes + BLOCK_ARRAY_BLOCK - 1) // BLOCK_ARRAY_BLOCK
    f.write(b"\x00" * (n_big * BLOCK_ARRAY_BLOCK - n_bytes))

    n_blocks = block_end_pos.size
    text_pos = int(char_counts.sum())
    for c in range(SIGMA):
        positions = block_char_cum[:, c] + np.arange(n_blocks, dtype=np.int64)
        sdsl.write_sd_vector(f, positions.astype(np.uint64),
                             int(char_counts[c]) + n_blocks)
        f.write(struct.pack("<Q", n_blocks))
    sdsl.write_sd_vector(f, (block_end_pos - 1).astype(np.uint64), text_pos)
    # serialize a C array derived from the ACTUAL streamed counts (the
    # caller's alpha provides the char mappings; its C may be stale)
    alpha = Alphabet.from_counts(char_counts, alpha_maps.char2comp,
                                 alpha_maps.comp2char)
    sdsl.write_int_vector(f, alpha.char2comp.astype(np.uint64), 8,
                          fixed_width=True)
    sdsl.write_int_vector(f, alpha.comp2char.astype(np.uint64), 8,
                          fixed_width=True)
    sdsl.write_int_vector(f, alpha.C.astype(np.uint64), 64,
                          fixed_width=True)
    f.write(struct.pack("<Q", alpha.sigma))

    header = NativeHeader(sequences=int(char_counts[0]), bases=text_pos)
    header.set_order(identify_alphabet(alpha_maps))
    f.seek(0)
    f.write(header.to_bytes())
    f.write(struct.pack("<Q", n_bytes))


class StreamingSGAWriter:
    """Chunked writer for the SGA format (byte-identical to SGAFormat.write).

    SGA codes come from the STORED run partition (64-byte-block splits), so
    each chunk walks the native Run codec's block rule at the running global
    offset, splitting at MAX_RUN=31 — fused in one C++ pass straight into a
    persistent code buffer (native/src/writer.cpp sga_stream_chunk)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(b"\x00" * SGAHeader.SIZE)
        # {global RLE byte offset, bases, sequences}, the last two summed
        # by the native kernel in its pass over each chunk
        self._state = np.zeros(3, dtype=np.int64)
        self._codes = np.empty(1 << 20, dtype=np.uint8)
        self.n_codes = 0
        self._closed = False

    @property
    def bases(self) -> int:
        return int(self._state[1])

    @property
    def sequences(self) -> int:
        return int(self._state[2])

    def write_chunk(self, syms: np.ndarray, lens: np.ndarray) -> None:
        if syms.size == 0:
            return
        from ..native import sga_stream_chunk_totals

        while True:
            n = sga_stream_chunk_totals(syms, lens, self._state, self._codes)
            if n != -2:
                break
            est = int(np.sum(lens, dtype=np.int64)) // 31 + 2 * syms.size + 1024
            self._codes = _grown(self._codes, max(2 * self._codes.size, est))
        if n < 0:
            raise RuntimeError(f"sga_stream_chunk failed (code {n})")
        self.f.write(self._codes[:n])
        self.n_codes += n

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        header = SGAHeader(sequences=self.sequences, bases=self.bases,
                           bytes_=self.n_codes)
        self.f.seek(0)
        self.f.write(header.to_bytes())
        self.f.close()


class NativeFragmentWriter:
    """Encode ONE fragment of a native file's RLE byte stream, resuming the
    64-byte block rule at a global byte offset with global prefix state
    (text position, char counts) — the per-process piece of a distributed
    native write (parallel/distributed.py).  Emits raw RLE bytes to `f` and
    collects per-block sample rows WITH block ids, so the stitcher can drop
    the duplicate row at each fragment seam (a 64-byte block spanning two
    fragments is reported by both; the later row carries the complete
    cumulative stats because this writer starts from the global prefix)."""

    def __init__(self, f, start_byte_offset: int, start_counts: np.ndarray):
        self.f = f
        self._state = np.zeros(2 + SIGMA, dtype=np.int64)
        self._state[0] = start_byte_offset
        self._state[1] = int(np.sum(start_counts, dtype=np.int64))
        self._state[2:] = start_counts
        self._rle = np.empty(1 << 20, dtype=np.uint8)
        self._blk_id = np.empty(1 << 15, dtype=np.int64)
        self._blk_end = np.empty(1 << 15, dtype=np.int64)
        self._blk_cc = np.empty((1 << 15) * SIGMA, dtype=np.int64)
        self._ids: List[np.ndarray] = []
        self._end: List[np.ndarray] = []
        self._cc: List[np.ndarray] = []

    @property
    def n_bytes_written(self) -> int:
        return int(self._state[0])

    def write_chunk(self, syms: np.ndarray, lens: np.ndarray) -> None:
        if syms.size == 0:
            return
        from ..native import native_stream_chunk

        prev_bytes = int(self._state[0])
        while True:
            rows = native_stream_chunk(syms, lens, self._state, self._rle,
                                       self._blk_id, self._blk_end,
                                       self._blk_cc)
            if rows != -2:
                break
            est_bytes = (2 * syms.size
                         + int(np.sum(lens, dtype=np.int64)) // 41 + 1024)
            self._rle = _grown(self._rle, max(2 * self._rle.size, est_bytes))
            est_rows = est_bytes // 64 + syms.size // 32 + 1024
            self._blk_id = _grown(self._blk_id, est_rows)
            self._blk_end = _grown(self._blk_end, est_rows)
            self._blk_cc = _grown(self._blk_cc, est_rows * SIGMA)
        if rows < 0:
            raise RuntimeError(f"native_stream_chunk failed (code {rows})")
        self.f.write(self._rle[: int(self._state[0]) - prev_bytes])
        self._ids.append(self._blk_id[:rows].copy())
        self._end.append(self._blk_end[:rows].copy())
        self._cc.append(self._blk_cc[: rows * SIGMA].reshape(rows, SIGMA).copy())

    def finish(self):
        """(block_ids, block_end_pos, block_char_cum) for this fragment,
        one row per touched 64-byte block (last update wins within the
        fragment); seam dedup across fragments is the stitcher's job."""
        if not self._ids:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros((0, SIGMA), np.int64))
        ids = np.concatenate(self._ids)
        end = np.concatenate(self._end)
        cc = np.vstack(self._cc)
        keep = np.ones(ids.size, bool)
        keep[:-1] = ids[:-1] != ids[1:]   # keep the LAST row of each block
        return ids[keep], end[keep], cc[keep]


class SGAFragmentWriter:
    """Encode ONE fragment of an SGA file's code stream, resuming the
    stored-run partition at a global RLE byte offset (the SGA codes derive
    from the 64-byte-block stored runs, so the phase matters even though the
    file bytes are codes)."""

    def __init__(self, f, start_rle_offset: int):
        self.f = f
        self._state = np.asarray([start_rle_offset], dtype=np.int64)
        self._codes = np.empty(1 << 20, dtype=np.uint8)
        self.n_codes = 0

    def write_chunk(self, syms: np.ndarray, lens: np.ndarray) -> None:
        if syms.size == 0:
            return
        from ..native import sga_stream_chunk

        while True:
            n = sga_stream_chunk(syms, lens, self._state, self._codes)
            if n != -2:
                break
            est = int(np.sum(lens, dtype=np.int64)) // 31 + 2 * syms.size + 1024
            self._codes = _grown(self._codes, max(2 * self._codes.size, est))
        if n < 0:
            raise RuntimeError(f"sga_stream_chunk failed (code {n})")
        self.f.write(self._codes[:n])
        self.n_codes += n


STREAM_WRITERS = {
    "native": lambda path, alpha: StreamingNativeWriter(path, alpha),
    "sga": lambda path, alpha: StreamingSGAWriter(path),
}


def write_bwt_stream(path: str, fmt: str, chunks, alpha: Alphabet) -> None:
    """Write a BWT from an iterator of (syms, lens) run chunks (int32 or
    int64 lens; int32 chunks may carry over-wide runs split into adjacent
    same-symbol entries, which the native kernels re-coalesce)."""
    if fmt not in STREAM_WRITERS:
        raise ValueError(f"no streaming writer for format: {fmt}")
    w = STREAM_WRITERS[fmt](path, alpha)
    for syms, lens in chunks:
        lens = np.asarray(lens)
        if lens.dtype != np.int32:
            lens = np.ascontiguousarray(lens, dtype=np.int64)
        w.write_chunk(np.asarray(syms, dtype=np.uint8), lens)
    w.close()
