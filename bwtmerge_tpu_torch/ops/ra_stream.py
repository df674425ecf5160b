"""A blocked search's rank array, block by block, as one ascending chunk
stream.

Port of the consumption side of bwtmerge_tpu/ops/search_jax.py
(BlockedPackedRA, make_block_part, stream_packed_ra), for the walk search
and the trie search alike.  The JAX package packs each block's runs into
byte, nibble and pair-code planes to spare its host link; here each
block's sorted-unique (int64 value, int64 count) pairs cross PCIe unpacked.

Blocks partition B's reads (or, on a mesh, B's reads over the shards).
Each block is searched and reduced on the device (walk_torch.walk_runs,
search_torch.search_block_runs); on CUDA its pairs are then copied into
pinned host memory on a side stream, so block k's copy overlaps block
k+1's search.  stream() merges the blocks' ascending streams with
merge_ra_chunk_streams, which sums values shared by blocks.

Host memory is bounded the way the JAX package bounds it, by the flags that
size its spill ladder (bwtmerge_tpu/models/merge.py:_build_ra_spill): a
BlockedRA with a budget of runs holds blocks whole while their pairs stay
within it, and drains every further block, on a thread of its own, into a
models/spill.RankArraySpill under the temp directory, one block at a time
(as models/kfold._StepDrainer drains a fold's steps).  The blocks held
then take at most the budget, and the block draining one block more.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..models.spill import RankArraySpill, merge_ra_chunk_streams

from .rank_torch import DeviceFMIndex
from .walk_torch import walk_runs


class Block:
    """One block's pairs on the host (or on their way there)."""

    def __init__(self, values: torch.Tensor, counts: torch.Tensor):
        if values.device.type == "cuda":
            compute = torch.cuda.current_stream(values.device)
            copy = torch.cuda.Stream(values.device)
            copy.wait_stream(compute)
            self.values = torch.empty(values.shape, dtype=values.dtype,
                                      pin_memory=True)
            self.counts = torch.empty(counts.shape, dtype=counts.dtype,
                                      pin_memory=True)
            with torch.cuda.stream(copy):
                self.values.copy_(values, non_blocking=True)
                self.counts.copy_(counts, non_blocking=True)
                self.done = torch.cuda.Event()
                self.done.record(copy)
            # the sources stay referenced until the copy has finished
            self._sources = (values, counts)
        else:
            self.values, self.counts = values, counts
            self.done = None
            self._sources = None

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def chunks(self, chunk_runs: int):
        if self.done is not None:
            self.done.synchronize()
            self._sources = None
        v, c = self.values.numpy(), self.counts.numpy()
        for s in range(0, v.size, chunk_runs):
            yield v[s:s + chunk_runs], c[s:s + chunk_runs]


class BlockedRA:
    """Per-block rank arrays consumed as one ascending sorted-unique
    (values, counts) chunk stream.  Duck-types the consumption surface the
    merges read (stream, finish, prefer_stream, n_spill_files,
    total_spilled_bytes, n_runs).

    budget_runs=None holds every block.  With a budget, add() holds blocks
    while the runs held stay within it and hands every further block to a
    drain thread, which moves its pairs into the RankArraySpill that
    make_spill() makes (the merges': models/merge._new_spill, under the
    temp directory) and writes them to a spill file; a further block waits
    until the one before it has drained.  add() may be called from several
    threads (the shards of a mesh)."""

    prefer_stream = True
    CHUNK = 2 * 1024 * 1024

    def __init__(self, budget_runs=None, make_spill=RankArraySpill):
        self.blocks = []
        self.budget_runs = budget_runs
        self._held = 0
        self._make_spill = make_spill
        self._lock = threading.Lock()
        self._drain_free = threading.Semaphore(1)
        self._queue = None
        self._thread = None
        self._spill = None
        self._drained_runs = 0
        self._error = None

    def add(self, values: torch.Tensor, counts: torch.Tensor) -> None:
        """One block's sorted-unique pairs, on its device."""
        n = int(values.shape[0])
        with self._lock:
            hold = self.budget_runs is None or self._held + n <= self.budget_runs
            if hold:
                self._held += n
        if hold:
            block = Block(values, counts)
            with self._lock:
                self.blocks.append(block)
            return
        while not self._drain_free.acquire(timeout=0.1):
            self._check()
        try:
            self._check()
            block = Block(values, counts)
            with self._lock:
                if self._thread is None:
                    self._spill = self._make_spill()
                    self._queue = queue.Queue()
                    self._thread = threading.Thread(target=self._drain_loop,
                                                    daemon=True)
                    self._thread.start()
                self._drained_runs += n
            self._queue.put(block)
        except BaseException:
            self._drain_free.release()
            raise

    def _drain_loop(self) -> None:
        while True:
            block = self._queue.get()
            if block is None:
                return
            try:
                if self._error is None:
                    for v, c in block.chunks(self.CHUNK):
                        self._spill.emit(v, c)
                    # the block's tail goes to disk too: a drained block
                    # leaves file handles, not host runs
                    self._spill._compact()
                    if self._spill._base is not None:
                        self._spill._spill()
            except BaseException as e:  # noqa: BLE001 - raised by _check
                self._error = e
            finally:
                del block
                self._drain_free.release()

    def _check(self) -> None:
        if self._error is not None:
            raise self._error

    def _finish_drain(self) -> None:
        """Wait until every block handed to the drain thread is on disk."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None
        self._check()

    @property
    def n_runs(self) -> int:
        """Upper bound of the merged run count (blocks may share values)."""
        return self._held + self._drained_runs

    @property
    def n_spill_files(self) -> int:
        return self._spill.n_spill_files if self._spill is not None else 0

    @property
    def total_spilled_bytes(self) -> int:
        return self._spill.total_spilled_bytes if self._spill is not None else 0

    def stream(self, chunk_runs: int = CHUNK):
        self._finish_drain()
        sources = [b.chunks(chunk_runs) for b in self.blocks]
        if self._spill is not None:
            sources.append(self._spill.stream(chunk_runs))
        return merge_ra_chunk_streams(sources, chunk_runs=chunk_runs)

    def finish(self):
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


def blocked_walk(index: DeviceFMIndex, planes: torch.Tensor,
                 creads: np.ndarray, n_blocks: int,
                 a_sequences: int, ra: BlockedRA = None) -> BlockedRA:
    """Walk creads int8[max_len, R] (host) in `n_blocks` read blocks through
    the index's wide planes (walk_torch.build_walk_planes) on its device,
    into `ra` (a BlockedRA that holds every block when None).  Each block's
    root share is its read count."""
    ra = BlockedRA() if ra is None else ra
    max_len, r_total = creads.shape
    n_blocks = max(1, min(n_blocks, r_total))
    per = -(-r_total // n_blocks)
    for b in range(0, r_total, per):
        blk = np.ascontiguousarray(creads[:, b:b + per])
        dev = torch.from_numpy(blk).to(index.device)
        ra.add(*walk_runs(planes, index.C, dev, a_sequences, blk.shape[1]))
    return ra
