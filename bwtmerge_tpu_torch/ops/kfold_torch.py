"""K-way fold by pairwise rank-array decomposition, in PyTorch.

Port of bwtmerge_tpu/ops/kfold_jax.py (see its docstring for the math).
The rank of piece k's suffix s in the accumulated base (pieces 0..k-1) is
the sum over the earlier pieces l of |{suffixes of piece l <= s}|, and each
term is one per-read walk of piece k's reads through piece l's resident
wide planes (the walk kernel K2).  Emission lane (t, r) is the same
suffix in every walk, so the per-suffix sum is a lane-wise add, followed by
one sort.

The sums run in an int64 total, so the JAX package's uint32 wraparound and
its UPAD pad marker have no counterpart here: a lane the first walk leaves
dead (the walk's SENT) is DEAD, the int64 maximum, and stays dead, so dead
lanes sort last.  Each lane block ends as a sorted-unique (int64 value,
int64 count) pair stream with the root run (the endmarker suffixes: value
sum of the earlier pieces' read counts, count the block's reads) summed in,
as walk_torch.walk_runs does for one walk; this replaces the JAX package's
plane packing (_pack_presorted).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .walk_torch import (SENT, WALK_BLOCK_EMITS, build_walk_planes,
                         walk_emit)

DEAD = 2**63 - 1   # dead summed lane: sorts last; 0xFFFFFFFF mod 2^32 (UPAD)
MAX_FOLD_TOTAL = (1 << 32) - 2   # the host chain is untried beyond 2^32
MAX_WALK_LANES = WALK_BLOCK_EMITS   # emission lanes per lane block


class PieceIndex:
    """One fold piece resident on the device: the walk's wide planes (`cpl`,
    walk_torch.build_walk_planes) + C (the record table is not kept; the
    walk only reads plane rows)."""

    def __init__(self, cpl: torch.Tensor, C: torch.Tensor, sequences: int,
                 size: int):
        self.cpl = cpl
        self.C = C
        self.sequences = int(sequences)
        self.size = int(size)

    @classmethod
    def from_device_index(cls, idx) -> "PieceIndex":
        return cls(build_walk_planes(idx.rec), idx.C, int(idx.C[1]), idx.size)


def _walk_raw(piece: PieceIndex, creads: torch.Tensor):
    """One pairwise walk, emissions in lane order (SENT in dead lanes),
    starting at piece.sequences (the '<=' tie convention: the earlier
    piece's endmarkers precede the walked piece's).  (emits int32[L*R],
    n_live int64 scalar tensor)."""
    return walk_emit(piece.cpl, piece.C, creads, piece.sequences)


def _first_lanes(emits: torch.Tensor) -> torch.Tensor:
    """The running total from the first walk: int64, dead lanes DEAD."""
    return torch.where(emits == SENT, DEAD, emits.to(torch.int64))


def _sum_lanes(total: torch.Tensor, emits: torch.Tensor) -> torch.Tensor:
    """Add one more walk lane by lane; dead lanes (the same lanes in every
    walk) stay DEAD."""
    return torch.where(total == DEAD, DEAD, total + emits.to(torch.int64))


def _sort_vals(vals: torch.Tensor) -> torch.Tensor:
    return torch.sort(vals).values


def _summed_block(targets: List[PieceIndex], block: torch.Tensor,
                  root_count: int):
    """One lane block's summed rank array: sorted-unique (values int64[U],
    counts int64[U]) on the device, the root run included."""
    total = None
    n_live = None
    root_value = 0
    for t in targets:
        emits, n_live = _walk_raw(t, block)
        total = _first_lanes(emits) if total is None \
            else _sum_lanes(total, emits)
        del emits
        root_value += t.sequences
    live = _sort_vals(total)[: int(n_live)]
    del total
    root = torch.tensor([root_value], dtype=torch.int64, device=live.device)
    # the root sorts before every emission (each walk emits >= its start),
    # and an emission equal to it joins the root's run
    values, counts = torch.unique_consecutive(torch.cat([root, live]),
                                              return_counts=True)
    counts[0] += root_count - 1
    return values, counts


def summed_part_thunks(targets: List[PieceIndex], creads):
    """The fold step's search as lazy per-lane-block thunks: calling one
    walks one block of `creads` (piece k's reads, int8[max_len, R], host
    array or device tensor) through every earlier piece and returns that
    block's (values, counts) pairs on the targets' device.  Blocks hold
    whole reads, so they partition the suffix multiset; the caller merges
    their ascending streams."""
    if not targets:
        raise ValueError("a fold step needs at least one earlier piece")
    max_len, r = creads.shape
    if sum(t.size for t in targets) + r >= MAX_FOLD_TOTAL:
        raise ValueError(
            "fold total reaches 2^32 positions, beyond what the fold has "
            "been shown to take; shard the fold")
    dev = targets[0].cpl.device
    if isinstance(creads, np.ndarray):
        creads = torch.from_numpy(np.ascontiguousarray(creads))
    creads = creads.to(dev)
    n_blocks = 1
    while max_len * -(-r // n_blocks) > MAX_WALK_LANES and n_blocks < r:
        n_blocks *= 2
    width = max(1, -(-r // n_blocks))

    def thunk(b):
        def run():
            block = creads[:, b:b + width].contiguous()
            return _summed_block(targets, block, block.shape[1])
        return run

    return [thunk(b) for b in range(0, r, width)]


def summed_parts(targets: List[PieceIndex], creads):
    """Eager list of per-block (values, counts) parts (tests, small
    pieces)."""
    return [t() for t in summed_part_thunks(targets, creads)]
