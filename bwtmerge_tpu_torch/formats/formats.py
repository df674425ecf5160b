"""The seven BWT file formats, byte-compatible with the reference.

Each format exposes:
    read(path)  -> (RunArrays maximal runs, counts int64[sigma], Alphabet)
    write(path, runs, alpha, sequences, bases)
    order()     -> AlphabeticOrder
    name / tag

Formats (reference formats.h:68-156):
    NativeFormat   full serialized FMI (header + RLE blocks + rank/select + alphabet)
    PlainFormatD/S BWT as a raw character array (default / sorted order)
    RFMFormat      int_vector<8> of comp values (sorted order)
    SDSLFormat     int_vector<8> of characters (sorted order)
    RopeFormat     1 byte/run: len<<3 | comp (MAX_RUN 31)
    SGAFormat      header + 1 byte/run: comp<<5 | len (MAX_RUN 31)

The Python implementations are the specification; the C++ runtime mirrors them
for bulk IO and is cross-checked byte-for-byte.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from ..models.runs import RunArrays, SIGMA
from ..utils.alphabet import Alphabet, AlphabeticOrder, create_alphabet
from . import codec
from .headers import NativeHeader, RopeHeader, SGAHeader
from . import sdsl_compat as sdsl

BLOCK_ARRAY_BLOCK = 8 * 1024 * 1024  # BlockArray::BLOCK_SIZE (support.h:95)
RLE_BLOCK = codec.RUN_BLOCK_SIZE      # 64; BWT::SAMPLE_RATE (bwt.h:49)


def _read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- plain / int_vector-framed formats ------------------------------------------


class _PlainBase:
    """Shared engine for character/comp-array formats (PlainData,
    formats.cpp:126-216)."""

    framed = False            # IntVectorBuffer framing (u64 bit-count header)?

    @classmethod
    def _alphabet(cls) -> Alphabet:
        return create_alphabet(cls.order())

    @classmethod
    def read(cls, path: str):
        raw = _read_file(path)
        if cls.framed:
            (bits,) = struct.unpack("<Q", raw[:8])
            values = np.frombuffer(raw[8 : 8 + bits // 8], dtype=np.uint8)
        else:
            values = np.frombuffer(raw, dtype=np.uint8)
        alpha = cls._alphabet()
        comps = alpha.char2comp[values]
        runs = RunArrays.from_values(comps)
        counts = runs.counts(SIGMA)
        return runs, counts, Alphabet.from_counts(counts, alpha.char2comp, alpha.comp2char)

    @classmethod
    def write(cls, path: str, runs: RunArrays, alpha: Alphabet,
              sequences: int, bases: int) -> None:
        # decode in bounded chunks (the reference's 1 MB PlainBuffer,
        # formats.cpp:170-216) — never the whole text
        comp2char = cls._alphabet().comp2char
        total = runs.size()
        with open(path, "wb") as f:
            if cls.framed:
                f.write(struct.pack("<Q", total * 8))
            for syms, lens in runs.iter_chunks(1 << 20):
                f.write(comp2char[np.repeat(syms, lens)].tobytes())
            if cls.framed:
                f.write(b"\x00" * ((-total) % 8))


class PlainFormatD(_PlainBase):
    name = "Plain format (default alphabet)"
    tag = "plain_default"

    @staticmethod
    def order() -> AlphabeticOrder:
        return AlphabeticOrder.DEFAULT


class PlainFormatS(_PlainBase):
    name = "Plain format (sorted alphabet)"
    tag = "plain_sorted"

    @staticmethod
    def order() -> AlphabeticOrder:
        return AlphabeticOrder.SORTED


class RFMFormat(_PlainBase):
    """int_vector<8> of comp values 0-5 (identity alphabet, formats.cpp:248-263)."""

    name = "RFM format"
    tag = "rfm"
    framed = True

    @staticmethod
    def order() -> AlphabeticOrder:
        return AlphabeticOrder.SORTED

    @classmethod
    def _alphabet(cls) -> Alphabet:
        return Alphabet.identity(SIGMA)

    @classmethod
    def read(cls, path: str):
        runs, counts, _ = super().read(path)
        # comp values are stored directly, but the logical alphabet is sorted.
        alpha = create_alphabet(AlphabeticOrder.SORTED)
        return runs, counts, Alphabet.from_counts(counts, alpha.char2comp, alpha.comp2char)


class SDSLFormat(_PlainBase):
    """int_vector<8> of characters, sorted alphabet (formats.cpp:267-277)."""

    name = "SDSL format"
    tag = "sdsl"
    framed = True

    @staticmethod
    def order() -> AlphabeticOrder:
        return AlphabeticOrder.SORTED


# -- byte-per-run external RLE formats -------------------------------------------


class _RopeBase:
    """Shared engine for RopeBWT/SGA codecs (RopeData, formats.cpp:281-363).

    Byte-exactness note: the reference writes these from its *stored-run*
    partition (Run::read over the BlockArray), so a maximal run that was split
    at a 64-byte RLE block boundary produces a different code sequence than an
    unsplit one. We therefore re-derive the stored partition before encoding.
    """

    MAX_RUN = 31
    # a code byte's layout, (sym_shift, sym_mask, len_shift, len_mask):
    # sym = (code >> sym_shift) & sym_mask, len = (code >> len_shift) &
    # len_mask (the native reader's, native.RopeRuns)
    CODE: Tuple[int, int, int, int]

    @staticmethod
    def order() -> AlphabeticOrder:
        return AlphabeticOrder.DEFAULT

    # subclass hooks
    @classmethod
    def _decode_codes(cls, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    @classmethod
    def _encode_codes(cls, syms: np.ndarray, lens: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def _split_runs(cls, runs: RunArrays) -> Tuple[np.ndarray, np.ndarray]:
        """Stored-run partition further split at MAX_RUN, vectorized."""
        syms, lens = codec.stored_runs(runs.syms, runs.lens)
        n_codes = (lens + cls.MAX_RUN - 1) // cls.MAX_RUN
        total = int(n_codes.sum())
        out_syms = np.repeat(syms, n_codes)
        out_lens = np.full(total, cls.MAX_RUN, dtype=np.int64)
        last_idx = np.cumsum(n_codes) - 1
        remainder = lens - (n_codes - 1) * cls.MAX_RUN
        out_lens[last_idx] = remainder
        return out_syms, out_lens

    @classmethod
    def _runs_from_codes(cls, codes: np.ndarray):
        syms, lens = cls._decode_codes(codes)
        runs = RunArrays.from_runs(syms, lens.astype(np.int64))
        counts = runs.counts(SIGMA)
        alpha = create_alphabet(cls.order())
        return runs, counts, Alphabet.from_counts(counts, alpha.char2comp, alpha.comp2char)


class RopeFormat(_RopeBase):
    """RopeBWT: u32 tag header + codes `len<<3 | comp` (formats.cpp:367-401)."""

    name = "RopeBWT format"
    tag = "ropebwt"
    CODE = (0, 0x07, 3, 0x1F)

    @classmethod
    def _decode_codes(cls, codes):
        return (codes & 0x07).astype(np.uint8), (codes >> 3).astype(np.int64)

    @classmethod
    def _encode_codes(cls, syms, lens):
        return ((lens.astype(np.uint16) << 3) | syms).astype(np.uint8)

    @classmethod
    def read(cls, path: str):
        raw = _read_file(path)
        header = RopeHeader.from_bytes(raw)
        if not header.check():
            raise ValueError(f"{path}: invalid RopeBWT header")
        return cls._runs_from_codes(np.frombuffer(raw[RopeHeader.SIZE :], dtype=np.uint8))

    @classmethod
    def write(cls, path: str, runs: RunArrays, alpha: Alphabet,
              sequences: int, bases: int) -> None:
        syms, lens = cls._split_runs(runs)
        with open(path, "wb") as f:
            f.write(RopeHeader().to_bytes())
            f.write(cls._encode_codes(syms, lens).tobytes())


class SGAFormat(_RopeBase):
    """SGA: 30-byte header + codes `comp<<5 | len` (formats.cpp:405-445)."""

    name = "SGA format"
    tag = "sga"
    CODE = (5, 0x07, 0, 0x1F)

    @classmethod
    def _decode_codes(cls, codes):
        return (codes >> 5).astype(np.uint8), (codes & 0x1F).astype(np.int64)

    @classmethod
    def _encode_codes(cls, syms, lens):
        return ((syms.astype(np.uint16) << 5) | lens.astype(np.uint16)).astype(np.uint8)

    @classmethod
    def read(cls, path: str):
        raw = _read_file(path)
        header = SGAHeader.from_bytes(raw)
        if not header.check():
            raise ValueError(f"{path}: invalid SGA header")
        codes = np.frombuffer(raw[SGAHeader.SIZE : SGAHeader.SIZE + header.bytes_],
                              dtype=np.uint8)
        return cls._runs_from_codes(codes)

    @classmethod
    def write(cls, path: str, runs: RunArrays, alpha: Alphabet,
              sequences: int, bases: int) -> None:
        # Delegate to the streaming writer (byte-identical; pinned by the
        # golden + --stream identity tests): the fused native kernel walks
        # the stored-run partition in one pass instead of materializing
        # the split-run arrays.
        from .streaming import StreamingSGAWriter

        w = StreamingSGAWriter(path)
        step = 1 << 22
        for s in range(0, runs.syms.size, step):
            w.write_chunk(runs.syms[s:s + step], runs.lens[s:s + step])
        w.close()


# -- native format ----------------------------------------------------------------


class NativeFormat:
    """Full serialized FMI (FMI::serialize<NativeFormat>, fmi.cpp:109-121):

    NativeHeader | BlockArray (u64 bytes + 8 MB zero-padded blocks) |
    6 x CumulativeArray (sd_vector + 0-byte supports + u64 size) |
    block_boundaries sd_vector | Alphabet (char2comp, comp2char, C, sigma).

    The only format that round-trips the rank/select structures.
    """

    name = "Native format"
    tag = "native"

    @staticmethod
    def order() -> AlphabeticOrder:
        return AlphabeticOrder.ANY

    @classmethod
    def read(cls, path: str):
        with open(path, "rb") as f:
            header = NativeHeader.from_bytes(f.read(NativeHeader.SIZE))
            if not header.check():
                raise ValueError(f"{path}: invalid native header")
            (n_bytes,) = struct.unpack("<Q", f.read(8))
            n_blocks = (n_bytes + BLOCK_ARRAY_BLOCK - 1) // BLOCK_ARRAY_BLOCK
            data = f.read(n_blocks * BLOCK_ARRAY_BLOCK)[:n_bytes]
            syms, lens = codec.decode_runs(data)
            runs = RunArrays.from_runs(syms, lens)
            for _c in range(SIGMA):
                sdsl.read_sd_vector(f)
                f.read(8)  # CumulativeArray m_size
            sdsl.read_sd_vector(f)  # block_boundaries
            char2comp, _ = sdsl.read_int_vector(f, 8)
            comp2char, _ = sdsl.read_int_vector(f, 8)
            C, _ = sdsl.read_int_vector(f, 64)
            (sigma,) = struct.unpack("<Q", f.read(8))
        alpha = Alphabet(
            char2comp=char2comp.astype(np.uint8),
            comp2char=comp2char.astype(np.uint8)[:sigma],
            C=C.astype(np.uint64),
        )
        counts = runs.counts(SIGMA)
        return runs, counts, alpha

    @classmethod
    def write(cls, path: str, runs: RunArrays, alpha: Alphabet,
              sequences: int, bases: int) -> None:
        # Delegate to the streaming writer (byte-identical; pinned by the
        # golden tests): the old batch path materialized a [n_runs, SIGMA]
        # int64 one-hot cumsum for the sample tables; the fused native
        # kernel (writer.cpp native_stream_chunk) does not.
        from .streaming import StreamingNativeWriter

        w = StreamingNativeWriter(path, alpha)
        step = 1 << 22
        for s in range(0, runs.syms.size, step):
            w.write_chunk(runs.syms[s:s + step], runs.lens[s:s + step])
        w.close()


# -- registry ----------------------------------------------------------------------

FORMATS = {
    f.tag: f
    for f in (NativeFormat, PlainFormatD, PlainFormatS, RFMFormat, SDSLFormat,
              RopeFormat, SGAFormat)
}


def format_exists(tag: str) -> bool:
    return tag in FORMATS


def read_bwt(path: str, fmt: str = "native"):
    """Load a BWT file -> (RunArrays, counts, Alphabet).

    Routed through the chunked streaming reader (streaming_read.py): peak
    transient memory is one 1 MB chunk plus the run arrays — never the whole
    raw file or the decoded text.  The per-format `read` classmethods remain
    as the batch specification the streaming path is tested against.
    """
    if fmt not in FORMATS:
        raise ValueError(f"invalid BWT format: {fmt}")
    from .streaming_read import read_bwt_streaming

    return read_bwt_streaming(path, fmt)


def write_bwt(path: str, fmt: str, runs: RunArrays, alpha: Alphabet,
              sequences: int | None = None, bases: int | None = None) -> None:
    if fmt not in FORMATS:
        raise ValueError(f"invalid BWT format: {fmt}")
    counts = runs.counts(SIGMA)
    if sequences is None:
        sequences = int(counts[0])
    if bases is None:
        bases = int(counts.sum())
    # The native format serializes the alphabet's C array verbatim; make sure
    # it reflects these runs even when the caller passes a bare mapping-only
    # Alphabet (C defaults to zeros).
    if not np.array_equal(np.asarray(alpha.C, dtype=np.int64)[1:],
                          np.cumsum(counts[: alpha.sigma])):
        alpha = Alphabet.from_counts(counts, alpha.char2comp, alpha.comp2char)
    FORMATS[fmt].write(path, runs, alpha, sequences, bases)
