"""BWT file formats: native, plain_default, plain_sorted, rfm, sdsl, ropebwt, sga.

Byte-compatible with the reference formats (formats.h:88-156); see each format
class for the exact layout.
"""

from .formats import (
    FORMATS,
    format_exists,
    read_bwt,
    write_bwt,
    NativeFormat,
    PlainFormatD,
    PlainFormatS,
    RFMFormat,
    SDSLFormat,
    RopeFormat,
    SGAFormat,
)
from .headers import NativeHeader, RopeHeader, SGAHeader

__all__ = [
    "FORMATS",
    "format_exists",
    "read_bwt",
    "write_bwt",
    "NativeFormat",
    "PlainFormatD",
    "PlainFormatS",
    "RFMFormat",
    "SDSLFormat",
    "RopeFormat",
    "SGAFormat",
    "NativeHeader",
    "RopeHeader",
    "SGAHeader",
]
