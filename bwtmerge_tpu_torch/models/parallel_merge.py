"""Range-parallel host interleave: the merge phase's interleave walk split
by ascending A-position ranges across a thread pool.

Port of bwtmerge_tpu/models/parallel_merge.py.  The reference's interleave
is one consumer thread walking both RLE inputs (bwt.cpp:215-282),
inherently serial.  Here every incoming rank-array chunk already owns a
disjoint ascending A-position range, so each chunk's interleave runs
independently: the native `interleave_chunk` kernel is initialized at the
range cursors (A at position lo, B at rank b_offset;
parallel/distributed.py interleave_range_chunks, applied to threads) and
releases the GIL, so fragments overlap on the host cores while results are
yielded strictly in order.  Fragment seams may split maximal runs; wrap the
stream in `coalesce_run_chunks` before a writer.

An option, not the default merge backend: the serial native chain
(native.interleave_stream_chunks) already overlaps interleave, writer and
decode on prefetch threads and reuses a persistent buffer ring, while
fragments allocate fresh output arrays and add coalesce work.  Which chain
wins depends on the host's cores; PERF.md holds the times measured on the
card's machine.  Byte identity with the serial chain is pinned by
tests/test_torch_interleave.py.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def interleave_stream_chunks_parallel(a_runs, b_runs, ra_chunks,
                                      workers: int = 3,
                                      max_inflight: int | None = None):
    """Generator of merged (syms, lens) run chunks: the contract of
    native.interleave_stream_chunks followed by coalesce_run_chunks at the
    consumer, but with per-chunk ranges interleaved concurrently.

    ra_chunks must be ascending sorted-unique (values strictly increase
    across chunk boundaries, as every rank-array stream of this package
    yields).  `max_inflight` bounds memory at O(inflight * fragment).
    """
    from ..parallel.distributed import interleave_range_chunks

    a_cum = np.cumsum(np.asarray(a_runs.lens), dtype=np.int64)
    b_cum = np.cumsum(np.asarray(b_runs.lens), dtype=np.int64)
    n_a = int(a_cum[-1]) if a_cum.size else 0
    if max_inflight is None:
        max_inflight = workers + 2

    def fragment(rv, rc, lo, hi, b_off, last):
        return list(interleave_range_chunks(
            a_runs, b_runs, iter([(rv, rc)]), lo, hi, b_off, last,
            a_cum=a_cum, b_cum=b_cum))

    ex = ThreadPoolExecutor(workers)
    try:
        pending: deque = deque()
        lo = 0
        b_off = 0
        for rv, rc in ra_chunks:
            rv = np.ascontiguousarray(rv, dtype=np.int64)
            rc = np.ascontiguousarray(rc, dtype=np.int64)
            if rv.size == 0:
                continue
            # a chunk that ends in the value |A| (B suffixes past every
            # suffix of A) has consumed A whole: its range ends at |A|, not
            # one past it, where the native cursor would refuse to go
            hi = min(int(rv[-1]) + 1, n_a)
            pending.append(ex.submit(fragment, rv, rc, lo, hi, b_off, False))
            lo = hi
            b_off += int(np.sum(rc, dtype=np.int64))
            while len(pending) >= max_inflight:
                yield from pending.popleft().result()
        # drain fragment: advance A from lo through its tail
        pending.append(ex.submit(fragment, np.zeros(0, np.int64),
                                 np.zeros(0, np.int64), lo, 2**62, b_off,
                                 True))
        while pending:
            yield from pending.popleft().result()
    finally:
        # cancel queued fragments too: without it an early generator close
        # (or a raising fragment) leaves in-flight tasks burning cores and
        # pinning the large run arrays until they finish
        ex.shutdown(wait=False, cancel_futures=True)
