"""Windowed streaming interleave: bounded host memory over chunked inputs.

The destructive-merge memory profile of the reference (BlockArray::clearUntil,
bwt.cpp:233-265, frees every consumed input block mid-merge so peak memory is
output + buffers) re-derived for the chunk-stream design: instead of freeing
blocks of resident inputs, the inputs are never resident at all.  A and B
arrive as ascending (syms, lens) run chunks (e.g. formats.streaming_read
.read_bwt_chunks), a sliding window holds only the span the current
rank-array chunk touches, and consumed runs are dropped as the merge
advances.  Peak host memory of the merge phase is O(window), independent of
|A|, |B|, and the output size.

Correctness hinges on two invariants of the stateful native kernel
(native/src/interleave.cpp interleave_chunk):

* The kernel's cursors are plain (run, remaining) pairs and the rank-array
  values are positions — both translate under a common rebasing, so a window
  starting at absolute position p behaves identically to the full array once
  every coordinate is shifted by -p.
* A rank-array run (v, k) may be split into (v', 0) gap fills (advance A
  only) and repeated (v, k_i) count splits (emit B only) without changing
  the merged sequence, because interleave_span treats `while a_pos < v` and
  `while k > 0` independently.  Rewriting the RA stream this way bounds the
  A-span and B-count of every kernel call by the window size.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

RunChunk = Tuple[np.ndarray, np.ndarray]


class _Window:
    """Sliding window over an ascending stream of (syms, lens) run chunks.

    Tracks the absolute text position of the window start (`base_pos`); runs
    before it have been consumed and dropped.  `extend_to(pos)` pulls chunks
    until the window covers absolute position `pos` (or the stream ends);
    `trim(pos)` drops whole runs that end at or before absolute position
    `pos`.  Seam runs are coalesced so a run split across source chunks
    never inflates the run count.
    """

    def __init__(self, chunks):
        self._it = iter(chunks)
        cap = 1 << 16
        self._s = np.empty(cap, dtype=np.uint8)
        self._l = np.empty(cap, dtype=np.int64)
        # absolute text position at the start of run i; slot head+n = end
        self._cum = np.empty(cap + 1, dtype=np.int64)
        self._cum[0] = 0
        self._head = 0
        self._n = 0
        self.exhausted = False
        self.max_window = 0  # peak positions held (observability/tests)

    # amortized ring-ish buffer: appends land at the tail, trims advance the
    # head, and the valid region is compacted to the front (memmove) only
    # when the tail hits capacity — the old rebuild-the-window-per-extend
    # np.concatenate chain cost O(window) per pulled chunk and dominated
    # chained k-way folds at the 900 Mbp tier

    @property
    def syms(self) -> np.ndarray:
        return self._s[self._head:self._head + self._n]

    @property
    def lens(self) -> np.ndarray:
        return self._l[self._head:self._head + self._n]

    @property
    def base_pos(self) -> int:
        return int(self._cum[self._head])

    @property
    def end_pos(self) -> int:
        return int(self._cum[self._head + self._n])

    def _reserve(self, add: int) -> None:
        cap = self._s.size
        if self._head + self._n + add <= cap:
            return
        if self._n + add <= cap // 2:
            h, n = self._head, self._n
            self._s[:n] = self._s[h:h + n]
            self._l[:n] = self._l[h:h + n]
            self._cum[:n + 1] = self._cum[h:h + n + 1]
            self._head = 0
            return
        new_cap = max(2 * cap, self._n + add)
        s = np.empty(new_cap, np.uint8)
        l = np.empty(new_cap, np.int64)
        c = np.empty(new_cap + 1, np.int64)
        h, n = self._head, self._n
        s[:n] = self._s[h:h + n]
        l[:n] = self._l[h:h + n]
        c[:n + 1] = self._cum[h:h + n + 1]
        self._s, self._l, self._cum = s, l, c
        self._head = 0

    def _append(self, s: np.ndarray, l: np.ndarray) -> None:
        # within-chunk seam coalesce (sources are maximal-run-clean except
        # run-splitting chunkers like RunArrays.iter_chunks)
        if s.size > 1 and bool(np.any(s[1:] == s[:-1])):
            keep = np.empty(s.size, dtype=bool)
            keep[0] = True
            np.not_equal(s[1:], s[:-1], out=keep[1:])
            idx = np.flatnonzero(keep)
            l = np.add.reduceat(l, idx)
            s = s[idx]
        t = self._head + self._n
        # boundary coalesce with the current tail run
        if self._n and s.size and self._s[t - 1] == s[0]:
            self._l[t - 1] += l[0]
            self._cum[t] += int(l[0])
            s, l = s[1:], l[1:]
        m = s.size
        if m == 0:
            return
        self._reserve(m)
        t = self._head + self._n
        self._s[t:t + m] = s
        self._l[t:t + m] = l
        np.cumsum(l, out=self._cum[t + 1:t + m + 1])
        self._cum[t + 1:t + m + 1] += self._cum[t]
        self._n += m

    def extend_to(self, pos: int) -> None:
        while not self.exhausted and self.end_pos < pos:
            try:
                s, l = next(self._it)
            except StopIteration:
                self.exhausted = True
                break
            if s.size == 0:
                continue
            self._append(np.ascontiguousarray(s, dtype=np.uint8),
                         np.ascontiguousarray(l, dtype=np.int64))
        self.max_window = max(self.max_window, self.end_pos - self.base_pos)

    def trim(self, pos: int) -> None:
        """Drop runs fully consumed below absolute position `pos`."""
        h, n = self._head, self._n
        if pos <= self._cum[h]:
            return
        k = int(np.searchsorted(self._cum[h:h + n + 1], pos,
                                side="right")) - 1
        k = min(k, n)  # keep a partially consumed run
        if k > 0:
            self._head += k
            self._n -= k

    def cursor(self, pos: int) -> Tuple[int, int]:
        """(run, remaining) window-relative cursor at absolute position."""
        h, n = self._head, self._n
        run = int(np.searchsorted(self._cum[h:h + n + 1], pos,
                                  side="right")) - 1
        if run >= n:
            return n, 0
        return run, int(self._cum[h + run + 1] - pos)


def _bounded_ra(ra_chunks, limit: int, a_start: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Rewrite ascending (values, counts) RA chunks so every yielded chunk
    spans <= limit A positions and <= limit B positions.

    Long A gaps become zero-count fill runs; long B counts repeat the value.
    Both rewrites are no-ops on the merged sequence (see module docstring).
    """
    a0 = a_start
    for rv, rc in ra_chunks:
        rv = np.ascontiguousarray(rv, dtype=np.int64)
        rc = np.ascontiguousarray(rc, dtype=np.int64)
        if rv.size == 0:
            continue
        if int(rv[-1]) - a0 <= limit and int(rc.sum()) <= limit:
            a0 = int(rv[-1])
            yield rv, rc
            continue

        # 1) split big counts: run i expands to ceil(k/limit) copies
        n_rep = np.maximum(1, -(-rc // limit))
        # 2) gap fills BEFORE run i: ceil(gap/limit) - 1 zero-count runs
        prev = np.concatenate(([a0], rv[:-1]))
        gaps = rv - prev
        n_fill = np.maximum(0, -(-gaps // limit) - 1)

        tot = n_rep + n_fill
        out_n = int(tot.sum())
        starts = np.concatenate(([0], np.cumsum(tot)))[:-1]
        # expansion slot j of run i: local index l = j - starts[i]
        owner = np.repeat(np.arange(rv.size), tot)
        local = np.arange(out_n) - starts[owner]
        is_fill = local < n_fill[owner]
        vals = np.where(
            is_fill,
            prev[owner] + (local + 1) * limit,
            rv[owner])
        # counts: fills 0; rep slot r = local - n_fill gets `limit`, last
        # slot gets the remainder
        r = local - n_fill[owner]
        last = r == (n_rep[owner] - 1)
        rem = rc[owner] - (n_rep[owner] - 1) * limit
        cnts = np.where(is_fill, 0, np.where(last, rem, limit))

        # 3) greedy partition: each sub-chunk spans <= limit and sums <= limit
        csum = np.concatenate(([0], np.cumsum(cnts)))
        s = 0
        base = a0
        while s < out_n:
            e1 = int(np.searchsorted(vals, base + limit, side="right"))
            e2 = int(np.searchsorted(csum, csum[s] + limit, side="right")) - 1
            e = max(s + 1, min(e1, e2))
            yield vals[s:e], cnts[s:e]
            base = int(vals[e - 1])
            s = e
        a0 = int(rv[-1])


def interleave_windowed_chunks(
    a_chunks, b_chunks, ra_chunks, *,
    window_positions: int = 1 << 24,
    stats: Optional[dict] = None,
    n_buffers: int = 4,
) -> Iterator[RunChunk]:
    """Merged (syms, lens) run chunks from chunked A, B, and rank-array
    streams, holding O(window_positions) host memory.

    The bounded-memory sibling of interleave_stream_chunks (native/api.py):
    same maximal-run-clean output contract, but A and B are chunk ITERATORS
    — e.g. read_bwt_chunks over the source files — instead of resident
    RunArrays.  Yielded arrays are views into a ring of `n_buffers` output
    buffers, so a consumer may hold up to n_buffers-2 chunks in flight —
    enough for a depth-2 prefetch_chunks stage between chained passes (the
    k-way fold pipeline, models/kfold.py).  `stats`, when given, receives
    {"max_window_positions": peak} on exit.
    """
    from .api import _configure_stream_interleave, _lib

    lib = _lib()
    _configure_stream_interleave(lib)

    limit = max(int(window_positions), 1024)
    a_win = _Window(a_chunks)
    b_win = _Window(b_chunks)
    a_pos = 0  # absolute A positions consumed
    b_pos = 0  # absolute B positions consumed
    withheld_sym, withheld_len = 0, 0
    state = np.zeros(7, dtype=np.int64)
    ring = [{"s": np.empty(1 << 16, dtype=np.uint8),
             "l": np.empty(1 << 16, dtype=np.int64)}
            for _ in range(max(2, n_buffers))]
    slot = [0]

    def call(rv_abs, rc, finish):
        nonlocal a_pos, b_pos, withheld_sym, withheld_len
        need_a = int(rv_abs[-1]) if rv_abs.size else a_pos
        need_b = b_pos + int(rc.sum())
        a_win.extend_to(need_a)
        b_win.extend_to(need_b)
        if a_win.end_pos < need_a or b_win.end_pos < need_b:
            raise ValueError(
                "rank-array stream inconsistent with inputs (value beyond "
                "|A| or counts beyond |B|)")
        ar, arem = a_win.cursor(a_pos)
        br, brem = b_win.cursor(b_pos)
        state[0], state[1] = ar, arem
        state[2], state[3] = br, brem
        state[4] = a_pos - a_win.base_pos
        state[5], state[6] = withheld_sym, withheld_len
        rv = rv_abs - a_win.base_pos
        # emitted-run bound (same shape as api.run_chunk's): A fragments +
        # B fragments + one split per RA run + finish tail
        cap = ((a_win.syms.size - ar) + (b_win.syms.size - br)
               + 2 * rv.size + 8)
        bufs = ring[slot[0]]
        slot[0] = (slot[0] + 1) % len(ring)
        if bufs["s"].size < cap:
            bufs["s"] = np.empty(max(cap, 2 * bufs["s"].size), dtype=np.uint8)
            bufs["l"] = np.empty(bufs["s"].size, dtype=np.int64)
        n = lib.interleave_chunk(
            a_win.syms, a_win.lens, a_win.syms.size,
            b_win.syms, b_win.lens, b_win.syms.size,
            rv, rc, rv.size, 1 if finish else 0,
            cap, state, bufs["s"], bufs["l"])
        if n == -1:
            raise ValueError(
                "rank-array stream inconsistent with inputs (value beyond "
                "|A| or counts not covering |B|)")
        if n < 0:
            raise RuntimeError(f"native interleave_chunk failed (code {n})")
        if rv_abs.size:
            a_pos = int(rv_abs[-1])
        b_pos = need_b
        withheld_sym, withheld_len = int(state[5]), int(state[6])
        a_win.trim(a_pos)
        b_win.trim(b_pos)
        return bufs["s"][:n], bufs["l"][:n]

    for rv, rc in _bounded_ra(ra_chunks, limit):
        s, l = call(rv, rc, finish=False)
        if s.size:
            yield s, l

    # drain the A tail windowed: advance in <= limit steps until the source
    # is exhausted, then a finishing call (which also checks B coverage)
    while True:
        a_win.extend_to(a_pos + limit)
        tail_end = a_win.end_pos
        if a_win.exhausted and tail_end <= a_pos + limit:
            rv = (np.array([tail_end], dtype=np.int64)
                  if tail_end > a_pos else np.zeros(0, dtype=np.int64))
            s, l = call(rv, np.zeros(rv.size, dtype=np.int64), finish=True)
            if not b_win.exhausted:
                # pull one more chunk to distinguish "consumed exactly"
                b_win.extend_to(b_pos + 1)
            if b_win.end_pos != b_pos:
                raise ValueError("rank-array stream did not cover all of B")
            if s.size:
                yield s, l
            break
        step = np.array([a_pos + limit], dtype=np.int64)
        s, l = call(step, np.zeros(1, dtype=np.int64), finish=False)
        if s.size:
            yield s, l

    if stats is not None:
        stats["max_window_positions"] = max(a_win.max_window,
                                            b_win.max_window)
