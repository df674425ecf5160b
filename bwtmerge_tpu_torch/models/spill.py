"""Out-of-core rank array: disk spills + streaming k-way merge.

The framework analog of the reference's buffer hierarchy (MergeBuffer,
fmi.cpp:139-218) and k-way disk merger (RankArray, support.h:576-638):

  RankArraySpill.emit()  <- per-depth / per-shard (a_pos, count) run chunks
     in-memory compaction ladder (sort + sum duplicates, vectorized)
     -> spill_threshold_runs exceeded: delta+varint spill file in temp_dir
  RankArraySpill.stream() -> bounded-memory ascending (values, counts)
     chunks from a vectorized k-way merge of all spill files + the resident
     array (numpy merges whole chunk frontiers at once instead of the
     reference's per-run binary heap, support.h:612-629)

Spill files use the native RLArray cell codec (native/src/spill.cpp), named
.bwtmerge_torch_<pid>_<k> like the reference's .bwtmerge_<host>_<pid>_<k>
(utils.cpp:124-134).  Unlike the reference — where a crash leaks the temp
files (RankArray only deletes them in its destructor, support.cpp:532-536) —
every live spill path is tracked in a process-wide registry and removed by an
atexit hook, so an unhandled exception or clean SIGTERM leaves no litter.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Iterator, List, Optional, Set, Tuple

import numpy as np

from ..ops.search_np import compact_rank_array

# -- crash-safe temp-file registry ------------------------------------------------

_live_spills: Set[str] = set()
_cleanup_registered = False


_SPILL_SEQ = __import__("itertools").count()


def _register_spill(path: str) -> None:
    global _cleanup_registered
    if not _cleanup_registered:
        atexit.register(cleanup_spills)
        _cleanup_registered = True
    _live_spills.add(path)


def cleanup_spills() -> int:
    """Remove every spill file still on disk (runs automatically at
    interpreter exit; callable eagerly from supervisors).  Returns the number
    of files removed."""
    removed = 0
    for p in list(_live_spills):
        try:
            os.remove(p)
            removed += 1
        except OSError:
            pass
        _live_spills.discard(p)
    return removed


class _SpillFile:
    """One sorted-unique spill file with stateful chunked decoding."""

    def __init__(self, path: str, n_runs: int):
        self.path = path
        self.n_runs = n_runs
        self._data: Optional[np.ndarray] = None
        self._state = np.zeros(2, dtype=np.int64)  # byte offset, prev value
        self.head_values = np.zeros(0, np.int64)
        self.head_counts = np.zeros(0, np.int64)
        self.exhausted = False

    def _ensure_open(self) -> None:
        if self._data is None:
            self._data = np.fromfile(self.path, dtype=np.uint8)

    def refill(self, chunk_runs: int) -> None:
        """Top up the in-memory head to ~chunk_runs runs."""
        if self.exhausted or self.head_values.size >= chunk_runs:
            return
        from ..native import ra_decode_chunk

        self._ensure_open()
        need = chunk_runs - self.head_values.size
        values, counts = ra_decode_chunk(self._data, self._state, need)
        if values.size < need:
            self.exhausted = True
            self._data = None
        self.head_values = np.concatenate([self.head_values, values])
        self.head_counts = np.concatenate([self.head_counts, counts])

    def take_until(self, bound: int) -> Tuple[np.ndarray, np.ndarray]:
        """Remove and return all head runs with value <= bound."""
        k = int(np.searchsorted(self.head_values, bound, side="right"))
        out = (self.head_values[:k], self.head_counts[:k])
        self.head_values = self.head_values[k:]
        self.head_counts = self.head_counts[k:]
        return out

    def done(self) -> bool:
        return self.exhausted and self.head_values.size == 0

    def delete(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
        _live_spills.discard(self.path)


class _ChunkSource:
    """Adapter: ascending (values, counts) chunk iterator -> the buffered
    head/refill/take_until surface _SpillFile exposes, so iterator sources
    join the same k-way frontier merge."""

    def __init__(self, it):
        self._it = it
        self.head_values = np.zeros(0, np.int64)
        self.head_counts = np.zeros(0, np.int64)
        self.exhausted = False

    def refill(self, chunk_runs: int) -> None:
        while not self.exhausted and self.head_values.size < chunk_runs:
            try:
                v, c = next(self._it)
            except StopIteration:
                self.exhausted = True
                return
            if v.size:
                self.head_values = np.concatenate([self.head_values, v])
                self.head_counts = np.concatenate([self.head_counts, c])

    take_until = _SpillFile.take_until
    done = _SpillFile.done


def merge_ra_chunk_streams(iters, chunk_runs: int = 4 * 1024 * 1024):
    """K-way merge of ascending sorted-unique (values, counts) chunk streams
    into one ascending sorted-unique chunk stream, summing duplicate values.

    The multi-device analog of RankArraySpill.stream's disk merge: each
    device's PackedDeviceRA.stream() is one source, so a mesh-sharded search
    result streams device->host->interleave without ever materializing the
    combined rank array (reference counterpart: the RankArray k-way disk
    merge, support.h:576-638, with devices in place of temp files)."""
    sources = [_ChunkSource(iter(it)) for it in iters]
    while True:
        for s in sources:
            s.refill(chunk_runs)
        live = [s for s in sources if not s.done()]
        if not live:
            return
        bound = min(int(s.head_values[-1]) for s in live
                    if s.head_values.size)
        parts = []
        for s in live:
            v, c = s.take_until(bound)
            if v.size:
                parts.append((v, c))
        if parts:
            merged = _merge_sorted_parts(parts)
            if merged[0].size:
                yield merged


class _MergeScratch(threading.local):
    """Grow-only int64 buffer pairs for the pairwise merge fold, keyed by
    (round parity, merge index) so no two live intermediates alias —
    intermediate merge results never allocate fresh pages.  Thread-local: spill compactions and the
    k-way chunk merges run on different threads (emit thread, prefetch
    threads) and must not share scratch."""

    def __init__(self):
        self._bufs = {}

    def pair(self, slot, n: int):
        b = self._bufs.get(slot)
        if b is None or b[0].size < n:
            b = (np.empty(n, np.int64), np.empty(n, np.int64))
            self._bufs[slot] = b
        return b


_merge_scratch = _MergeScratch()


def _merge_sorted_parts(parts):
    """Merge k sorted-unique (values, counts) run lists into one.

    Pairwise linear merges folded tournament-style — O(n log k) linear work
    instead of the O(n log n) argsort a concatenate+compact pays.  The hot
    op is the native single-pass ra_merge_pair; intermediates live in reused
    scratch, and only the final result is a fresh array the caller owns."""
    from ..native import ra_merge_pair

    ping = 0
    while len(parts) > 1:
        last_round = len(parts) <= 2
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            a, b = parts[i], parts[i + 1]
            if last_round:
                nxt.append(ra_merge_pair(a, b))  # caller-owned fresh arrays
            else:
                n = a[0].size + b[0].size
                nxt.append(ra_merge_pair(
                    a, b, *_merge_scratch.pair((ping, i // 2), n)))
        if len(parts) & 1:
            nxt.append(parts[-1])
        parts = nxt
        ping ^= 1
    v, c = parts[0]
    return np.asarray(v, np.int64), np.asarray(c, np.int64)


class RankArraySpill:
    """Rank-array accumulator with bounded host memory.

    emit() chunks are compacted in memory; when the resident array exceeds
    `spill_threshold_runs`, it is delta+varint-encoded to a temp file.
    stream() yields globally sorted unique (values, counts) chunks.
    """

    def __init__(self, temp_dir: str = ".", spill_threshold_runs: int = 64 * 1024 * 1024,
                 compact_every: int = 16 * 1024 * 1024):
        self.temp_dir = temp_dir
        self.spill_threshold_runs = spill_threshold_runs
        self.compact_every = compact_every
        self._chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._base: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._files: List[_SpillFile] = []
        self._file_seq = None  # per-process global (see _spill)
        self.total_spilled_bytes = 0

    # -- accumulation ---------------------------------------------------------

    def emit(self, values: np.ndarray, counts: np.ndarray) -> None:
        if values.size == 0:
            return
        self._chunks.append((values, counts))
        self._pending += values.size
        if self._pending >= self.compact_every:
            self._compact()
        if self._base is not None and self._base[0].size >= self.spill_threshold_runs:
            self._spill()

    def _compact(self) -> None:
        if not self._chunks:
            return
        from ..ops.search_np import compact_sorted_rank_array

        # Emitted chunks are usually ALREADY ascending (device-packed
        # streams, numpy search results); concatenating them first would
        # destroy that and pay an O(n log n) argsort over the whole batch.
        # Instead every chunk is
        # compacted individually (linear for sorted ones) and the batch +
        # resident base fold through the native pairwise tournament merge
        # — the vector analog of the reference's RLArray
        # 2-way-merge ladder (support.h:434-453).
        parts = []
        for v, c in self._chunks:
            v = np.asarray(v)
            c = np.asarray(c)
            if v.size > 1 and not np.all(v[1:] >= v[:-1]):
                parts.append(compact_rank_array(v, c))
            else:
                parts.append(compact_sorted_rank_array(
                    v.astype(np.int64), c.astype(np.int64)))
        if self._base is not None:
            parts.append(self._base)
        self._base = _merge_sorted_parts(parts)
        self._chunks = []
        self._pending = 0

    def _spill(self) -> None:
        from ..native import ra_encode

        values, counts = self._base
        # PROCESS-GLOBAL sequence: several spill accumulators can live at
        # once (one per k-way fold step, models/kfold.py) — a per-instance
        # counter made them overwrite each other's temp files
        path = os.path.join(self.temp_dir,
                            f".bwtmerge_torch_{os.getpid()}_{next(_SPILL_SEQ)}")
        data = ra_encode(values, counts)
        with open(path, "wb") as f:
            f.write(data)
        _register_spill(path)
        self.total_spilled_bytes += len(data)
        self._files.append(_SpillFile(path, values.size))
        self._base = None

    # -- consumption ----------------------------------------------------------

    def stream(self, chunk_runs: int = 4 * 1024 * 1024
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ascending sorted-unique (values, counts) chunks; values never
        overlap across chunks.  Consumes and deletes the spill files.

        Each spill file decodes on its own prefetch thread (the native
        delta+varint decode releases the GIL), so k decodes overlap the
        k-way merge — the same pipelining BlockedPackedRA.stream uses for
        device streams."""
        from ..utils.pipeline import prefetch_chunks

        self._compact()
        sources: List[_SpillFile] = list(self._files)
        resident = self._base
        self._base = None
        self._files = []

        def file_chunks(f: _SpillFile):
            while True:
                f.refill(chunk_runs)
                v, c = f.head_values, f.head_counts
                f.head_values = np.zeros(0, np.int64)
                f.head_counts = np.zeros(0, np.int64)
                if v.size:
                    yield v, c
                if f.exhausted:
                    return

        def resident_chunks(v, c):
            for s in range(0, v.size, chunk_runs):
                yield v[s:s + chunk_runs], c[s:s + chunk_runs]

        iters = [prefetch_chunks(file_chunks(f), depth=2) for f in sources]
        if resident is not None and resident[0].size:
            iters.append(resident_chunks(*resident))
        try:
            yield from merge_ra_chunk_streams(iters, chunk_runs=chunk_runs)
        finally:
            for f in sources:
                f.delete()

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Fully materialized rank array (small inputs / tests)."""
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    @property
    def n_spill_files(self) -> int:
        return len(self._files)
