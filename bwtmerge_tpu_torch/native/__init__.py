"""Native C++ runtime bindings (codecs, format IO, interleave, spill merge).

The shared library is built at first use from native/src with g++ (see
native/build.py).  A build or load failure raises where the first native
function is called; the port has no numpy fallback for these functions.
"""

from .api import (  # noqa: F401
    byte_counts,
    fnv1a_bytes,
    fragment_phase_table,
    interleave_native,
    interleave_stream_chunks,
    interleave_streaming,
    native_stream_chunk,
    nib4_pack,
    ra_decode_chunk,
    ra_decode_nib_chunk,
    ra_decode_q4_chunk,
    ra_encode,
    ra_merge_pair,
    RopeRuns,
    rle_decode,
    rle_encode,
    rle_encode_at,
    rle_hash,
    run_block_sums,
    run_sym_sums,
    sga_stream_chunk,
    sga_stream_chunk_totals,
)
from .build import load_library  # noqa: F401
