"""Sharded merge output on the host: the interleave of ONE A-position range
and the coalescing of run chunks across range seams.

Port of the host half of bwtmerge_tpu/parallel/distributed.py
(_range_cursor, interleave_range_chunks, coalesce_run_chunks): numpy and the
port's native library only.  Each range of the interleave runs
independently, the stateful native kernel initialized at the range's
cursors, so ranges can go to threads (models/parallel_merge.py) or, later,
to processes; fragments concatenate in range order through one streaming
format writer, with the seam runs coalesced.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _range_cursor(lens: np.ndarray, pos: int,
                  cum: Optional[np.ndarray] = None) -> Tuple[int, int]:
    """(run index, remaining-in-run) cursor at absolute position `pos` of an
    RLE stream (prefix-sum binary search, the host analog of
    interleave.cpp cursor_at).  Pass a precomputed `cum` (np.cumsum(lens))
    when calling per-fragment — recomputing it is O(runs) per call."""
    if pos <= 0:
        return 0, int(lens[0]) if lens.size else 0
    if cum is None:
        cum = np.cumsum(lens)
    run = int(np.searchsorted(cum, pos, side="right"))
    if run >= lens.size:
        return int(lens.size), 0
    return run, int(cum[run] - pos)


def interleave_range_chunks(a_runs, b_runs, ra_chunks, lo: int, hi: int,
                            b_offset: int, last: bool,
                            chunk_runs: int = 1 << 20,
                            a_cum: Optional[np.ndarray] = None,
                            b_cum: Optional[np.ndarray] = None):
    """Generator of merged (syms, lens) run chunks for ONE A-position range
    [lo, hi) of the interleave, given that range's ascending RA chunks and
    the B-rank offset of its first insertion.

    The stateful native kernel is initialized at the range cursors (A at
    position lo, B at rank b_offset); after the RA runs, A is advanced to
    `hi` with a synthetic zero-count entry (`last` drains A's tail
    instead).  The trailing run is NOT withheld — the shard concatenator
    coalesces seams.  Shards produced for consecutive ranges concatenate
    into exactly the full interleave's run stream (up to seam splits).
    """
    from ..native.api import _as_i64, _as_u8, _configure_stream_interleave, _lib

    lib = _lib()
    _configure_stream_interleave(lib)
    a_syms, a_lens = _as_u8(a_runs.syms), _as_i64(a_runs.lens)
    b_syms, b_lens = _as_u8(b_runs.syms), _as_i64(b_runs.lens)

    state = np.zeros(7, np.int64)
    state[0], state[1] = _range_cursor(a_lens, lo, a_cum)
    state[2], state[3] = _range_cursor(b_lens, b_offset, b_cum)
    state[4] = lo

    def run(rv, rc, finish):
        rv, rc = _as_i64(rv), _as_i64(rc)
        # emitted-run bound: A fragments (touched runs + one split per RA
        # run) + B fragments likewise — position spans bound the touched
        # runs but must not drive the allocation (a sparse range's span can
        # be orders of magnitude larger than its run count)
        span = (int(rv[-1]) - int(state[4])) if rv.size else 0
        cap = (min(max(span, 0), a_lens.size + 1)
               + min(int(rc.sum()), b_lens.size + 1) + 2 * rv.size + 16)
        if finish:
            cap += a_lens.size + 2
        out_s = np.empty(cap, np.uint8)
        out_l = np.empty(cap, np.int64)
        n = lib.interleave_chunk(a_syms, a_lens, a_syms.size,
                                 b_syms, b_lens, b_syms.size,
                                 rv, rc, rv.size, 1 if finish else 0,
                                 cap, state, out_s, out_l)
        if n == -1:
            raise ValueError("rank-array range inconsistent with inputs")
        if n < 0:
            raise RuntimeError(f"native interleave_chunk failed (code {n})")
        return out_s[:n], out_l[:n]

    for rv, rc in ra_chunks:
        if len(rv) == 0:
            continue
        s, l = run(rv, rc, finish=False)
        if s.size:
            yield s, l
    if last:
        s, l = run(np.zeros(0, np.int64), np.zeros(0, np.int64), finish=True)
        if s.size:
            yield s, l
    else:
        # advance A to the range end with a zero-count entry, then flush
        # the withheld trailing run (the next shard starts at a_pos = hi).
        # Collapsed (empty, lo == hi) ranges have nothing to advance.
        if hi > int(state[4]):
            s, l = run(np.asarray([hi], np.int64),
                       np.asarray([0], np.int64), finish=False)
            if s.size:
                yield s, l
        if state[6] > 0:
            yield (np.asarray([state[5]], np.uint8),
                   np.asarray([state[6]], np.int64))
            state[6] = 0


def coalesce_run_chunks(chunks):
    """Re-establish maximal runs across a chunk stream whose boundaries may
    split runs (shard seams): withholds each chunk's trailing run and
    merges it with the next chunk's head when the symbols match."""
    pend = None  # (sym, len)
    for syms, lens in chunks:
        if syms.size == 0:
            continue
        syms = np.asarray(syms, np.uint8)
        lens = np.asarray(lens, np.int64)
        if pend is not None:
            if syms[0] == pend[0]:
                lens = lens.copy()
                lens[0] += pend[1]
            else:
                yield (np.asarray([pend[0]], np.uint8),
                       np.asarray([pend[1]], np.int64))
        pend = (int(syms[-1]), int(lens[-1]))
        if syms.size > 1:
            yield syms[:-1], lens[:-1]
    if pend is not None:
        yield (np.asarray([pend[0]], np.uint8),
               np.asarray([pend[1]], np.int64))
