"""File headers for the BWT formats (byte-exact with reference formats.h/cpp).

All fields little-endian, packed in write order with no alignment padding
(SDSL write_member writes raw PODs):

- NativeHeader (formats.h:44-62):  u32 tag=0x54574221 ("!BWT"), u32 flags
  (low byte = alphabet order), u64 sequences, u64 bases. 24 bytes.
- RopeHeader (formats.h:175-187):  u32 tag=0x06454C52 ("RLE\\x06"). 4 bytes.
- SGAHeader (formats.h:191-207):   u16 tag=0xCACA, u64 sequences, u64 bases,
  u64 bytes (count of run codes), u32 flags=0. 30 bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..utils.alphabet import AlphabeticOrder


@dataclass
class NativeHeader:
    tag: int = 0x54574221
    flags: int = 0
    sequences: int = 0
    bases: int = 0

    DEFAULT_TAG = 0x54574221
    ALPHABET_MASK = 0xFF
    SIZE = 24
    _FMT = "<IIQQ"

    def to_bytes(self) -> bytes:
        return struct.pack(self._FMT, self.tag, self.flags, self.sequences, self.bases)

    @classmethod
    def from_bytes(cls, data: bytes) -> "NativeHeader":
        tag, flags, sequences, bases = struct.unpack(cls._FMT, data[: cls.SIZE])
        return cls(tag, flags, sequences, bases)

    def check(self) -> bool:
        return self.tag == self.DEFAULT_TAG

    def order(self) -> AlphabeticOrder:
        try:
            return AlphabeticOrder(self.flags & self.ALPHABET_MASK)
        except ValueError:
            return AlphabeticOrder.UNKNOWN

    def set_order(self, order: AlphabeticOrder) -> None:
        self.flags = (self.flags & ~self.ALPHABET_MASK) | (int(order) & self.ALPHABET_MASK)

    def __str__(self) -> str:
        from ..utils.alphabet import alphabet_name

        return (f"Native format: {self.sequences} sequences, {self.bases} bases, "
                f"{alphabet_name(self.order())} alphabet")


@dataclass
class RopeHeader:
    tag: int = 0x06454C52

    DEFAULT_TAG = 0x06454C52
    SIZE = 4
    _FMT = "<I"

    def to_bytes(self) -> bytes:
        return struct.pack(self._FMT, self.tag)

    @classmethod
    def from_bytes(cls, data: bytes) -> "RopeHeader":
        return cls(struct.unpack(cls._FMT, data[: cls.SIZE])[0])

    def check(self) -> bool:
        return self.tag == self.DEFAULT_TAG

    def __str__(self) -> str:
        return "RopeBWT format"


@dataclass
class SGAHeader:
    tag: int = 0xCACA
    sequences: int = 0
    bases: int = 0
    bytes_: int = 0  # number of run codes in the payload
    flags: int = 0

    DEFAULT_TAG = 0xCACA
    DEFAULT_FLAGS = 0
    SIZE = 30
    _FMT = "<HQQQI"

    def to_bytes(self) -> bytes:
        return struct.pack(self._FMT, self.tag, self.sequences, self.bases,
                           self.bytes_, self.flags)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SGAHeader":
        tag, sequences, bases, bytes_, flags = struct.unpack(cls._FMT, data[: cls.SIZE])
        return cls(tag, sequences, bases, bytes_, flags)

    def check(self) -> bool:
        return self.tag == self.DEFAULT_TAG and self.flags == self.DEFAULT_FLAGS

    def __str__(self) -> str:
        return (f"SGA format: {self.sequences} sequences, {self.bases} bases, "
                f"{self.bytes_} bytes")
