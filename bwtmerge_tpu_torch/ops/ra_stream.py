"""A blocked search's rank array, block by block, as one ascending chunk
stream.

Port of the consumption side of bwtmerge_tpu/ops/search_jax.py
(BlockedPackedRA, make_block_part, stream_packed_ra), for the walk search
and the trie search alike.  The JAX package packs each block's runs into
byte, nibble and pair-code planes to spare its host link; here each
block's sorted-unique (int64 value, int64 count) pairs cross PCIe unpacked.

Blocks partition B's reads.  Each block is searched and reduced on the
device (walk_torch.walk_runs, search_torch.search_block_runs); on CUDA its
pairs are then copied into pinned host memory on a side stream, so block
k's copy overlaps block k+1's search.  stream() merges the blocks'
ascending streams with merge_ra_chunk_streams, which sums values shared by
blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spill import merge_ra_chunk_streams

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
    total_spilled_bytes, n_runs)."""

    prefer_stream = True
    n_spill_files = 0
    total_spilled_bytes = 0
    CHUNK = 2 * 1024 * 1024

    def __init__(self, blocks):
        self.blocks = list(blocks)

    @property
    def n_runs(self) -> int:
        """Upper bound of the merged run count (blocks may share values)."""
        return sum(len(b) for b in self.blocks)

    def stream(self, chunk_runs: int = CHUNK):
        return merge_ra_chunk_streams([b.chunks(chunk_runs)
                                       for b in self.blocks],
                                      chunk_runs=chunk_runs)

    def finish(self):
        parts = list(self.stream())
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


def blocked_walk(index: DeviceFMIndex, cpl: torch.Tensor, creads: np.ndarray,
                 n_blocks: int, a_sequences: int) -> BlockedRA:
    """Walk creads int8[max_len, R] (host) in `n_blocks` read blocks on the
    index's device.  Each block's root share is its read count."""
    max_len, r_total = creads.shape
    n_blocks = max(1, min(n_blocks, r_total))
    per = -(-r_total // n_blocks)
    blocks = []
    for b in range(0, r_total, per):
        blk = np.ascontiguousarray(creads[:, b:b + per])
        dev = torch.from_numpy(blk).to(index.device)
        values, counts = walk_runs(cpl, index.C, dev, a_sequences,
                                   blk.shape[1])
        blocks.append(Block(values, counts))
    return BlockedRA(blocks)
