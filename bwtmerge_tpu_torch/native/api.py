"""ctypes bindings over the native C++ runtime."""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from .build import load_library

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _lib() -> ctypes.CDLL:
    lib = load_library()
    if not getattr(lib, "_bwtmerge_configured", False):
        lib.rle_encode_size.restype = ctypes.c_int64
        lib.rle_encode_size.argtypes = [_u8p, _i64p, ctypes.c_int64]
        lib.rle_encode.restype = ctypes.c_int64
        lib.rle_encode.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p]
        lib.rle_decode_count.restype = ctypes.c_int64
        lib.rle_decode_count.argtypes = [_u8p, ctypes.c_int64]
        lib.rle_decode.restype = ctypes.c_int64
        lib.rle_decode.argtypes = [_u8p, ctypes.c_int64, _u8p, _i64p, ctypes.c_void_p]
        lib.rle_hash_runs.restype = ctypes.c_uint64
        lib.rle_hash_runs.argtypes = [_u8p, _i64p, ctypes.c_int64]
        lib.fnv1a_bytes.restype = ctypes.c_uint64
        lib.fnv1a_bytes.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint64]
        lib.interleave_runs.restype = ctypes.c_int64
        lib.interleave_runs.argtypes = [
            _u8p, _i64p, ctypes.c_int64,
            _u8p, _i64p, ctypes.c_int64,
            _i64p, _i64p, ctypes.c_int64,
            _u8p, _i64p,
        ]
        lib.interleave_runs_parallel.restype = ctypes.c_int64
        lib.interleave_runs_parallel.argtypes = [
            _u8p, _i64p, ctypes.c_int64,
            _u8p, _i64p, ctypes.c_int64,
            _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            _u8p, _i64p,
        ]
        lib.ra_encode_size.restype = ctypes.c_int64
        lib.ra_encode_size.argtypes = [_i64p, _i64p, ctypes.c_int64]
        lib.ra_encode.restype = ctypes.c_int64
        lib.ra_encode.argtypes = [_i64p, _i64p, ctypes.c_int64, _u8p]
        lib.ra_decode_chunk.restype = ctypes.c_int64
        lib.ra_decode_chunk.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                        _i64p, _i64p, _i64p]
        lib.ra_merge_pair.restype = ctypes.c_int64
        lib.ra_merge_pair.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                      _i64p, _i64p, ctypes.c_int64,
                                      _i64p, _i64p]
        lib._bwtmerge_configured = True
    return lib


def _as_u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def rle_encode(syms, lens) -> bytes:
    """Run arrays -> reference-native RLE byte stream (Run::write semantics)."""
    syms, lens = _as_u8(syms), _as_i64(lens)
    lib = _lib()
    size = lib.rle_encode_size(syms, lens, syms.size)
    out = np.empty(size, dtype=np.uint8)
    written = lib.rle_encode(syms, lens, syms.size, out)
    assert written == size
    return out.tobytes()


def rle_decode(data, with_offsets: bool = False
               ) -> Tuple[np.ndarray, np.ndarray] | Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RLE byte stream -> stored run arrays (syms, lens[, byte offsets])."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    lib = _lib()
    n = lib.rle_decode_count(buf, buf.size)
    syms = np.empty(n, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int64)
    offsets: Optional[np.ndarray] = np.empty(n, dtype=np.int64) if with_offsets else None
    off_ptr = offsets.ctypes.data_as(ctypes.c_void_p) if with_offsets else None
    decoded = lib.rle_decode(buf, buf.size, syms, lens, off_ptr)
    assert decoded == n
    if with_offsets:
        return syms, lens, offsets
    return syms, lens


def rle_hash(syms, lens) -> int:
    """FNV-1a over the decoded sequence."""
    syms, lens = _as_u8(syms), _as_i64(lens)
    return int(_lib().rle_hash_runs(syms, lens, syms.size))


def fnv1a_bytes(data, seed: int = 0xCBF29CE484222325) -> int:
    """FNV-1a over raw bytes (codec.cpp fnv1a_bytes) at memory speed."""
    data = _as_u8(data)
    return int(_lib().fnv1a_bytes(data, data.size, ctypes.c_uint64(seed)))


def interleave_native(a_runs, b_runs, ra_values, ra_counts,
                      threads: Optional[int] = None):
    """Merged RunArrays of A and B according to the rank array.

    Runs the C++ interleave sliced over `threads` workers (default: all
    cores) — each slice's A/B/output offsets are prefix-sum expressions, the
    parallel decomposition the reference's single consumer thread
    (bwt.cpp:215-282) could not use.  Raises ValueError when the rank array
    is inconsistent with the inputs (value > |A| or counts not covering |B|).
    """
    import os

    from ..models.runs import RunArrays

    if threads is None:
        threads = os.cpu_count() or 1
    a_syms, a_lens = _as_u8(a_runs.syms), _as_i64(a_runs.lens)
    b_syms, b_lens = _as_u8(b_runs.syms), _as_i64(b_runs.lens)
    rv, rc = _as_i64(ra_values), _as_i64(ra_counts)
    cap = a_syms.size + b_syms.size + 2 * rv.size + 1 + max(1, threads)
    out_syms = np.empty(cap, dtype=np.uint8)
    out_lens = np.empty(cap, dtype=np.int64)
    n = _lib().interleave_runs_parallel(
        a_syms, a_lens, a_syms.size, b_syms, b_lens, b_syms.size,
        rv, rc, rv.size, threads, out_syms, out_lens)
    if n == -1:
        raise ValueError(
            "rank array inconsistent with inputs: values must be <= |A| and "
            f"counts must sum to |B| ({int(rc.sum())} vs {int(b_lens.sum())})")
    if n < 0:
        raise RuntimeError(f"native interleave failed (code {n})")
    return RunArrays(out_syms[:n].copy(), out_lens[:n].copy())


def ra_merge_pair(a: Tuple[np.ndarray, np.ndarray],
                  b: Tuple[np.ndarray, np.ndarray],
                  out_v: Optional[np.ndarray] = None,
                  out_k: Optional[np.ndarray] = None):
    """Linear 2-way merge of sorted-unique (values, counts) run lists,
    summing counts of equal values (RLArray merge analog, support.h:434-453).

    When `out_v`/`out_k` (int64, size >= len(a)+len(b)) are given the merge
    writes into them and returns VIEWS — callers reuse persistent buffers so
    that no merge call faults in fresh pages."""
    va, ka = _as_i64(a[0]), _as_i64(a[1])
    vb, kb = _as_i64(b[0]), _as_i64(b[1])
    n = va.size + vb.size
    if out_v is None or out_v.size < n:
        out_v = np.empty(n, dtype=np.int64)
        out_k = np.empty(n, dtype=np.int64)
    m = _lib().ra_merge_pair(va, ka, va.size, vb, kb, vb.size, out_v, out_k)
    return out_v[:m], out_k[:m]


def ra_encode(values, counts) -> bytes:
    """Sorted (value, count) runs -> delta+varint byte stream (RLArray cell
    layout, support.h:505-516)."""
    values, counts = _as_i64(values), _as_i64(counts)
    lib = _lib()
    size = lib.ra_encode_size(values, counts, values.size)
    out = np.empty(size, dtype=np.uint8)
    written = lib.ra_encode(values, counts, values.size, out)
    assert written == size
    return out.tobytes()


def ra_decode_chunk(data: np.ndarray, state: np.ndarray, max_runs: int):
    """Decode up to max_runs runs resuming from state = [byte_offset,
    prev_value] (updated in place).  Returns (values, counts) int64 arrays."""
    values = np.empty(max_runs, dtype=np.int64)
    counts = np.empty(max_runs, dtype=np.int64)
    n = _lib().ra_decode_chunk(data, data.size, max_runs, state, values, counts)
    return values[:n], counts[:n]


def _configure_ra_decode(lib) -> None:
    if getattr(lib, "_bwtmerge_radecode_configured", False):
        return
    lib.ra_decode_nib_chunk.restype = ctypes.c_int64
    lib.ra_decode_nib_chunk.argtypes = [
        _u8p, ctypes.c_int64,
        _u8p, _u8p, ctypes.c_int64,
        _i64p, _i64p, _i64p, ctypes.c_int64,
        _i64p, ctypes.c_int32, _i64p, _i64p,
    ]
    lib.ra_decode_q4_chunk.restype = ctypes.c_int64
    lib.ra_decode_q4_chunk.argtypes = [
        _u8p, ctypes.c_int64, _i64p, _i64p,
        _u8p, _u8p, ctypes.c_int64,
        _i64p, _i64p, _i64p, ctypes.c_int64,
        _i64p, ctypes.c_int32, _i64p, _i64p,
    ]
    lib._bwtmerge_radecode_configured = True


def _esc_rows(esc) -> Tuple[np.ndarray, np.ndarray, int]:
    """(delta row, count row, n) views of a [2, k] uint8 escape stream."""
    esc = _as_u8(esc)
    if esc.ndim != 2 or esc.shape[0] != 2:
        raise ValueError("escape stream must be uint8[2, k]")
    return np.ascontiguousarray(esc[0]), np.ascontiguousarray(esc[1]), esc.shape[1]


def ra_decode_nib_chunk(nib: np.ndarray, esc: np.ndarray,
                        exc_idx, exc_delta, exc_count,
                        state: np.ndarray, finish: bool):
    """One fused pass from a window of the device's packed nibble plane to
    dedup-summed sorted (values, counts) runs.

    nib: uint8[m] plane bytes (marker byte 15 = escape lane); esc: the
    block's FULL uint8[2, k] escape stream of (delta, count) byte pairs
    (the running cursor lives in state[4]); exc_*: window-relative
    ascending >254-outlier rows; state: int64[5] = {carry, pend_v, pend_c,
    have_pend, esc_off}, updated in place (the trailing run is withheld
    until `finish` so cross-chunk duplicates merge).  Replaces the numpy
    nibble-split/cumsum/reduceat chain in stream_packed_ra — one
    GIL-released sweep instead of five materialized intermediates.  Raises
    ValueError when the escape stream would overrun (corrupt packed RA).
    """
    lib = _lib()
    _configure_ra_decode(lib)
    nib = _as_u8(nib)
    ed8, ec8, n_esc = _esc_rows(esc)
    ei, ed, ec = _as_i64(exc_idx), _as_i64(exc_delta), _as_i64(exc_count)
    out_v = np.empty(nib.size + 1, dtype=np.int64)
    out_c = np.empty(nib.size + 1, dtype=np.int64)
    n = lib.ra_decode_nib_chunk(nib, nib.size, ed8, ec8, n_esc,
                                ei, ed, ec, ei.size,
                                state, 1 if finish else 0, out_v, out_c)
    if n < 0:
        raise ValueError("nibble escape stream exhausted (corrupt "
                         "packed RA)")
    return out_v[:n], out_c[:n]


def ra_decode_q4_chunk(q4: np.ndarray, m: int, esc: np.ndarray,
                       exc_idx, exc_delta, exc_count,
                       state: np.ndarray, finish: bool,
                       tab_d: np.ndarray, tab_c: np.ndarray):
    """One fused pass from a window of the device's pair-code plane (two
    4-bit codes per byte, Q4_PAIRS tables, code 15 -> one (delta, count)
    byte pair from the lane-ordered side stream `esc`) to dedup-summed
    sorted (values, counts) runs.

    q4: uint8[>= ceil(m/2)] window bytes (window starts are even); m: lanes
    in the window; esc: the block's FULL uint8[2, k] escape stream (the
    running cursor lives in state[4]); exc_*: window-relative ascending
    >254-outlier rows; state: int64[5] = {carry, pend_v, pend_c,
    have_pend, esc_off}, updated in place.  tab_d/tab_c: the 16-entry
    (delta, count) code tables (the packing side's pair-code tables).  Raises
    ValueError when the escape stream would overrun (corrupt packed RA).
    """
    lib = _lib()
    _configure_ra_decode(lib)
    q4 = _as_u8(q4)
    ed8, ec8, n_esc = _esc_rows(esc)
    ei, ed, ec = _as_i64(exc_idx), _as_i64(exc_delta), _as_i64(exc_count)
    td, tc = _as_i64(tab_d), _as_i64(tab_c)
    out_v = np.empty(m + 1, dtype=np.int64)
    out_c = np.empty(m + 1, dtype=np.int64)
    n = lib.ra_decode_q4_chunk(q4, m, td, tc, ed8, ec8, n_esc,
                               ei, ed, ec, ei.size,
                               state, 1 if finish else 0, out_v, out_c)
    if n < 0:
        raise ValueError("pair-code escape stream exhausted (corrupt "
                         "packed RA)")
    return out_v[:n], out_c[:n]


def _configure_stream_interleave(lib) -> None:
    if getattr(lib, "_bwtmerge_stream_configured", False):
        return
    lib.interleave_state_init.restype = None
    lib.interleave_state_init.argtypes = [_i64p, ctypes.c_int64, _i64p,
                                          ctypes.c_int64, _i64p]
    lib.interleave_chunk.restype = ctypes.c_int64
    lib.interleave_chunk.argtypes = [
        _u8p, _i64p, ctypes.c_int64,
        _u8p, _i64p, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _u8p, _i64p,
    ]
    lib.interleave_ctx_new.restype = ctypes.c_void_p
    lib.interleave_ctx_new.argtypes = [
        _u8p, _i64p, ctypes.c_int64,
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.interleave_ctx_chunk.restype = ctypes.c_int64
    lib.interleave_ctx_chunk.argtypes = [
        ctypes.c_void_p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _u8p, _i64p,
    ]
    lib.interleave_ctx_chunk32.restype = ctypes.c_int64
    lib.interleave_ctx_chunk32.argtypes = [
        ctypes.c_void_p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _u8p, _i32p,
    ]
    lib.interleave_ctx_free.restype = None
    lib.interleave_ctx_free.argtypes = [ctypes.c_void_p]
    lib._bwtmerge_stream_configured = True


# Process-wide pool of interleave output buffer pairs: checked out per
# generator, returned on close.  Buffers grow to their steady-state size once
# and are REUSED across merge passes: re-faulting the ring's pages on every merge
# call can cost more than the interleave itself.
_il_buffer_pool: list = []

# RA chunks are re-sliced to this many runs before interleaving: output
# buffer size scales with the RA chunk's span, so huge transfer-side chunks
# (sized for D2H link efficiency) must not dictate host buffer footprint.
IL_CHUNK_RUNS = 1 << 20


def interleave_stream_chunks(a_runs, b_runs, ra_chunks, n_buffers: int = 3,
                             max_chunk_runs: int = IL_CHUNK_RUNS):
    """Generator of merged (syms, lens) run chunks from ascending rank-array
    chunks — the fully streaming merge phase: neither the rank array nor the
    merged output is ever materialized whole.  Chunks are maximal-run clean:
    the stateful C++ emitter withholds the trailing run until the next chunk
    coalesces with it.

    Incoming RA chunks are internally re-sliced to `max_chunk_runs` so the
    output buffers stay small regardless of the producer's (transfer-
    optimized) chunking.  Yielded arrays are VIEWS into a rotation of
    `n_buffers` reused buffer pairs — chunk k stays valid until chunk
    k+n_buffers-1 is produced.  With the default 3, a depth-1
    prefetch_chunks stage between this generator and a writer is safe: the
    producer computes k+2 while the queue holds k+1 and the consumer reads
    k.  Consumers that retain chunks longer must copy (interleave_streaming
    does)."""
    lib = _lib()
    _configure_stream_interleave(lib)

    a_syms, a_lens = _as_u8(a_runs.syms), _as_i64(a_runs.lens)
    b_syms, b_lens = _as_u8(b_runs.syms), _as_i64(b_runs.lens)

    # chunk-internal thread parallelism: slices of each RA chunk interleave
    # independently into disjoint regions of the output buffer (cursor and
    # offset starts are chunk-LOCAL prefix-sum arithmetic held inside the
    # C++ context — full-length prefix sums over A/B would cost more in
    # first-touch page faults than the interleave itself).  One core stays
    # free for the producer thread feeding this generator
    # (BWTMERGE_IL_THREADS overrides).
    n_threads = int(os.environ.get("BWTMERGE_IL_THREADS", 0)) or \
        max(1, (os.cpu_count() or 2) - 1)
    ctx = lib.interleave_ctx_new(a_syms, a_lens, a_syms.size,
                                 b_syms, b_lens, b_syms.size, n_threads)

    a_total_pos = int(a_lens.sum())
    consumed = {"a_pos": 0, "b_pos": 0}
    # int32 run lengths: the chain is memory-bandwidth-bound and (sym, len)
    # pairs cross it twice (interleave stores, writer loads) — 5 B/run
    # instead of 9.  Over-wide runs arrive as adjacent same-symbol entries
    # (RunEmitterT<int32> splits); the int32-aware writers re-coalesce.
    ring = [_il_buffer_pool.pop() if _il_buffer_pool
            else {"s": np.empty(1 << 16, dtype=np.uint8),
                  "l": np.empty(1 << 16, dtype=np.int32)}
            for _ in range(max(1, n_buffers))]
    turn = {"i": 0}

    def run_chunk(rv, rc, finish):
        bufs = ring[turn["i"]]
        turn["i"] = (turn["i"] + 1) % len(ring)
        rv, rc = _as_i64(rv), _as_i64(rc)
        # Emitted-run bound: fragments of A touched this chunk (min of the
        # position span and the positions remaining, plus one split per RA
        # run) + fragments of B likewise; finish adds A's tail.  The C++
        # checks its exact per-slice bound BEFORE writing and returns -2
        # (state unchanged) when short — then retry with a doubled buffer.
        a_span = int(rv[-1]) - consumed["a_pos"] if rv.size else 0
        cap_a = max(a_span, 0) + rv.size + 2
        cap_b = int(rc.sum()) + rv.size + 2
        tail = min(a_lens.size, a_total_pos - consumed["a_pos"]) + 2
        cap = cap_a + cap_b + (tail if finish else 0)
        cap = max(cap + 12 * (n_threads + 1), 16)  # + per-slice seam slack
        while True:
            if bufs["s"].size < cap:
                bufs["s"] = np.empty(max(cap, 2 * bufs["s"].size),
                                     dtype=np.uint8)
                bufs["l"] = np.empty(bufs["s"].size, dtype=np.int32)
            out_s, out_l = bufs["s"], bufs["l"]
            n = lib.interleave_ctx_chunk32(ctx, rv, rc, rv.size,
                                           1 if finish else 0,
                                           out_s.size, out_s, out_l)
            if n != -2:
                break
            cap = 2 * bufs["s"].size
        if n == -1:
            raise ValueError(
                "rank-array stream inconsistent with inputs (value beyond "
                "|A| or counts beyond/not covering |B|)")
        if n < 0:
            raise RuntimeError(f"native interleave_chunk failed (code {n})")
        if rv.size:
            consumed["a_pos"] = int(rv[-1])
        consumed["b_pos"] += int(rc.sum())
        return out_s[:n], out_l[:n]

    # producer thread: the RA chunk production (device->host copies, numpy
    # cumsum/duplicate-sum passes) overlaps the interleave, which releases
    # the GIL inside the ctypes call — the reference's two-thread pipeline
    # (bwt.cpp:152-190) with the RABuffer slot as a depth-2 queue
    from ..utils.pipeline import prefetch_chunks

    def sliced(chunks):
        for rv, rc in chunks:
            for s in range(0, len(rv), max_chunk_runs):
                yield rv[s:s + max_chunk_runs], rc[s:s + max_chunk_runs]

    try:
        for rv, rc in prefetch_chunks(sliced(ra_chunks), depth=2):
            s, l = run_chunk(rv, rc, finish=False)
            if s.size:
                yield s, l
        s, l = run_chunk(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         finish=True)
        if s.size:
            yield s, l
    finally:
        lib.interleave_ctx_free(ctx)
        _il_buffer_pool.extend(ring)


def interleave_streaming(a_runs, b_runs, ra_chunks, hint_runs: int = 0):
    """Merged RunArrays from an iterator of ascending rank-array chunks
    (materializing wrapper over interleave_stream_chunks).

    Chunks fill the final int64 arrays DIRECTLY (chunks are views into the
    reused interleave ring, and the old copy-list + concatenate + astype
    chain touched about four times the output bytes in fresh pages).
    `hint_runs`, when given, sizes the buffers once (an upper bound: |A| runs + |B| runs + 2 splits per RA run); otherwise
    they grow geometrically."""
    from ..models.runs import RunArrays

    cap = max(int(hint_runs), 1 << 20)
    syms = np.empty(cap, np.uint8)
    lens = np.empty(cap, np.int64)
    n = 0
    for s, l in interleave_stream_chunks(a_runs, b_runs, ra_chunks):
        need = n + s.size
        if need > cap:
            cap = max(need, cap * 2)
            ns = np.empty(cap, np.uint8)
            ns[:n] = syms[:n]
            syms = ns
            nl = np.empty(cap, np.int64)
            nl[:n] = lens[:n]
            lens = nl
        syms[n:need] = s
        lens[n:need] = l        # int32 chunk -> int64 store, no temporary
        n = need
    if n == 0:
        return RunArrays.empty()
    if cap - n > max(cap // 16, 1 << 20):
        # hint_runs is an upper bound (a+b+2*RA runs): slicing would pin the
        # full-capacity buffers (9 B/run of slack) behind the views for the
        # whole next fold — copy to exact size when the slack is material,
        # keep the zero-copy slice for tight fits
        syms = syms[:n].copy()
        lens = lens[:n].copy()
    else:
        syms = syms[:n]
        lens = lens[:n]
    if syms.size > 1 and bool(np.any(syms[1:] == syms[:-1])):
        # >2^31 runs arrive split into adjacent same-symbol entries
        return RunArrays(syms, lens).coalesced()
    return RunArrays(syms, lens)


def _configure_encode_at(lib) -> None:
    if getattr(lib, "_bwtmerge_encat_configured", False):
        return
    lib.rle_encode_size_at.restype = ctypes.c_int64
    lib.rle_encode_size_at.argtypes = [_u8p, _i64p, ctypes.c_int64, ctypes.c_int64]
    lib.rle_encode_at.restype = ctypes.c_int64
    lib.rle_encode_at.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p, ctypes.c_int64]
    lib._bwtmerge_encat_configured = True


def _configure_stream_writers(lib) -> None:
    if getattr(lib, "_bwtmerge_writer_configured", False):
        return
    lib.sga_stream_chunk.restype = ctypes.c_int64
    lib.sga_stream_chunk.argtypes = [_u8p, _i64p, ctypes.c_int64, _i64p,
                                     _u8p, ctypes.c_int64]
    lib.native_stream_chunk.restype = ctypes.c_int64
    lib.native_stream_chunk.argtypes = [
        _u8p, _i64p, ctypes.c_int64, _i64p,
        _u8p, ctypes.c_int64, _i64p, _i64p, _i64p, ctypes.c_int64,
    ]
    lib.sga_stream_chunk32.restype = ctypes.c_int64
    lib.sga_stream_chunk32.argtypes = [_u8p, _i32p, ctypes.c_int64, _i64p,
                                       _u8p, ctypes.c_int64]
    lib.native_stream_chunk32.restype = ctypes.c_int64
    lib.native_stream_chunk32.argtypes = [
        _u8p, _i32p, ctypes.c_int64, _i64p,
        _u8p, ctypes.c_int64, _i64p, _i64p, _i64p, ctypes.c_int64,
    ]
    lib.fragment_phase_table.restype = ctypes.c_int64
    lib.fragment_phase_table.argtypes = [_u8p, _i64p, ctypes.c_int64, _i64p]
    lib._bwtmerge_writer_configured = True


def sga_stream_chunk(syms, lens, state: np.ndarray, out: np.ndarray) -> int:
    """Encode a run chunk into SGA codes inside the caller's persistent `out`
    buffer, resuming the stored-run partition at state[0] (updated).  Returns
    the number of codes, or -2 when `out` is too small (state unchanged).
    Accepts int32 OR int64 lens (int32 chunks may carry split runs as
    adjacent same-symbol entries; the kernel re-coalesces them)."""
    lib = _lib()
    _configure_stream_writers(lib)
    lens = np.asarray(lens)
    if lens.dtype == np.int32:
        return int(lib.sga_stream_chunk32(
            _as_u8(syms), np.ascontiguousarray(lens), len(syms),
            state, out, out.size))
    return int(lib.sga_stream_chunk(_as_u8(syms), _as_i64(lens), len(syms),
                                    state, out, out.size))


def native_stream_chunk(syms, lens, state: np.ndarray, rle: np.ndarray,
                        blk_id: np.ndarray, blk_end: np.ndarray,
                        blk_cc: np.ndarray) -> int:
    """Encode a run chunk into native RLE bytes + per-64-byte-block sample
    rows, all in caller-owned persistent buffers.  state = int64[8]
    {rle_offset, text_pos, counts[6]}, updated on success.  Returns the row
    count, or -2 when a buffer is too small (state unchanged)."""
    lib = _lib()
    _configure_stream_writers(lib)
    lens = np.asarray(lens)
    if lens.dtype == np.int32:
        return int(lib.native_stream_chunk32(
            _as_u8(syms), np.ascontiguousarray(lens), len(syms), state,
            rle, rle.size, blk_id, blk_end, blk_cc, blk_id.size))
    return int(lib.native_stream_chunk(
        _as_u8(syms), _as_i64(lens), len(syms), state,
        rle, rle.size, blk_id, blk_end, blk_cc, blk_id.size))


def _configure_nib4(lib) -> None:
    if getattr(lib, "_bwtmerge_nib4_configured", False):
        return
    lib.nib4_pack.restype = ctypes.c_int64
    lib.nib4_pack.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p,
                              ctypes.c_int64]
    lib._bwtmerge_nib4_configured = True


def nib4_pack(syms, lens, out: np.ndarray) -> int:
    """Expand run arrays into the block-planar 4-bit device upload layout
    (DeviceFMIndex.build) inside the caller's pre-filled buffer `out`
    (uint8, one byte per two positions).  Returns positions written."""
    syms, lens = _as_u8(syms), _as_i64(lens)
    lib = _lib()
    _configure_nib4(lib)
    n = lib.nib4_pack(syms, lens, syms.size, out, out.size * 2)
    if n < 0:
        raise ValueError("nib4_pack: buffer too small for the run total")
    return int(n)


def fragment_phase_table(syms, lens) -> np.ndarray:
    """64-phase transfer table of a run fragment: row 0 = native RLE byte
    counts, row 1 = SGA code counts, one column per start phase of the
    global byte offset (the Run codec's block rule is position-dependent,
    support.h:256-282).  O(64 * runs) native work, no byte materialization."""
    syms, lens = _as_u8(syms), _as_i64(lens)
    lib = _lib()
    _configure_stream_writers(lib)
    out = np.empty(2 * 64, dtype=np.int64)
    rc = lib.fragment_phase_table(syms, lens, syms.size, out)
    if rc != 0:
        raise RuntimeError(f"fragment_phase_table failed (code {rc})")
    return out.reshape(2, 64)


def rle_encode_at(syms, lens, start_offset: int) -> bytes:
    """Run arrays -> native RLE bytes resuming the 64-byte block rule at the
    given global byte offset (for chunked/streaming writers)."""
    syms, lens = _as_u8(syms), _as_i64(lens)
    lib = _lib()
    _configure_encode_at(lib)
    size = lib.rle_encode_size_at(syms, lens, syms.size, start_offset)
    out = np.empty(size, dtype=np.uint8)
    written = lib.rle_encode_at(syms, lens, syms.size, out, start_offset)
    assert written == size
    return out.tobytes()
