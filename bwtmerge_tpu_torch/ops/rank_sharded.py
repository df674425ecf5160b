"""Block-sharded FM-index: a record table split over the devices of a mesh,
for BWTs larger than one device's memory.

Port of bwtmerge_tpu/ops/rank_sharded.py.  The single-device layout
(ops/rank_torch.py) keeps the whole record table on one device (2 B a
position).  Here shard d owns the contiguous slab of 32-position blocks
[d*S, (d+1)*S) on its own device, and a batched rank query is answered
slab-locally and summed:

    every shard receives every query (queries are small: Q * 8 B);
    a shard answers the queries whose block it owns and gives 0 lanes for
    the others (the occ columns of each record are GLOBAL cumulative
    counts, so the owner's answer is complete by itself);
    the sum over the shards, on the first mesh entry, is the answer.

The JAX package answers a shard's part with an XLA program (_probe_local);
here it is torch ops over rank_torch.probe_rows, and the psum is a sum of
the shards' parts moved to the first mesh entry.  The searches over such
indexes (sharded_backward_search_blocked, wavefront_search_sharded) are
host loops, one batch of rank queries a step, with no static capacity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..models.runs import RunArrays
from ..parallel.mesh import mesh_devices
from .rank_torch import (BLK, LANES, NIB_FILL, SIGMA, build_rec, c_array,
                         probe_rows)
from .search_torch import compact_pairs


@dataclass(frozen=True)
class ShardedFMIndex:
    """Record table split by block rows over a 1-D mesh."""

    slabs: List[torch.Tensor]   # int32[slab, REC] each, on its mesh entry
    C: torch.Tensor             # int32[LANES+1], on the first mesh entry
    size: int
    slab: int                   # block rows per shard

    @property
    def n_shards(self) -> int:
        return len(self.slabs)

    @classmethod
    def build(cls, runs: RunArrays, C=None, mesh=None) -> "ShardedFMIndex":
        """Stream record-table slabs host -> owning device, one at a time.

        No device and no host temporary ever holds more than one slab: the
        host nibble-packs each slab's 32-position blocks from the run
        stream, uploads 0.5 B a position to the owning device, and the
        device derives its own [slab, REC] records (rank_torch.build_rec,
        given the slab-start occ base: rank_jax._build_rec_slab's role);
        the bases come from a host prefix over the runs, so the occ
        columns stay GLOBAL cumulative counts.  `C` is the
        per-character counts (default: counted from the runs)."""
        devices = mesh_devices(mesh)
        n = len(devices)
        size = runs.size()
        if size >= 2**31 - 1:
            raise ValueError("shard the collection first: 2^31 positions "
                             "per block-sharded index (int32 layout)")
        nblk = size // BLK + 1
        slab = -(-nblk // n)
        slab_pos = slab * BLK

        counts = runs.counts(SIGMA) if C is None else np.asarray(C)
        # slab-start global occ bases: one prefix pass over the runs
        starts = runs.run_starts()
        bases = np.zeros((n, LANES), dtype=np.int64)
        onehot_cum = np.zeros(LANES, dtype=np.int64)
        cum = np.concatenate((starts, [size]))
        for d in range(1, n):
            lo, hi = min((d - 1) * slab_pos, size), min(d * slab_pos, size)
            i0 = int(np.searchsorted(cum, lo, side="right")) - 1
            i1 = int(np.searchsorted(cum, hi, side="left"))
            if i1 > i0:
                s = runs.syms[i0:i1]
                ln = runs.lens[i0:i1].astype(np.int64)
                ln[0] -= lo - cum[i0]
                ln[-1] -= cum[i1] - hi
                onehot_cum += np.bincount(s, weights=ln,
                                          minlength=LANES).astype(np.int64)
            bases[d] = onehot_cum

        slabs = []
        chunks = runs.iter_chunks(slab_pos)
        for d, dev in enumerate(devices):
            # host temporary: ONE slab of nibbles (0.5 B a position)
            nib = np.full(slab_pos // 2, NIB_FILL, dtype=np.uint8)
            if min(d * slab_pos, size) < size:
                c_syms, c_lens = next(chunks)
                win = np.repeat(c_syms, c_lens).astype(np.uint8)
                if win.size % BLK:
                    win = np.concatenate(
                        [win, np.full((-win.size) % BLK, SIGMA, np.uint8)])
                blk2 = win.reshape(-1, BLK)
                packed = (blk2[:, :16] | (blk2[:, 16:] << 4)).astype(np.uint8)
                nib[: packed.size] = packed.reshape(-1)
            slabs.append(build_rec(torch.from_numpy(nib).to(dev), slab,
                                   base=torch.from_numpy(bases[d])))
        C_dev = torch.from_numpy(c_array(counts)).to(devices[0])
        return cls(slabs=slabs, C=C_dev, size=size, slab=slab)

    # -- queries ---------------------------------------------------------------

    def _probe_local(self, d: int, i: torch.Tensor) -> torch.Tensor:
        """Shard d's part of ranks_all: int32[Q, LANES], zero rows for the
        queries whose block it does not own."""
        rec = self.slabs[d]
        local = i.to(rec.device) - d * self.slab * BLK
        j = local >> 5
        owned = (j >= 0) & (j < self.slab)
        occ, syms, before, _ = probe_rows(
            rec, local.clamp(0, self.slab * BLK - 1))
        cols = [((syms == c) & before).sum(dim=1, dtype=torch.int32)
                for c in range(LANES)]
        res = occ + torch.stack(cols, dim=1)
        return torch.where(owned[:, None], res, torch.zeros_like(res))

    def ranks_all(self, i) -> torch.Tensor:
        """rank(i, c) for every c: int32[Q, LANES] on the first mesh entry;
        i (int, any device) in [0, size]."""
        i = torch.as_tensor(i).to(torch.int64)
        first = self.C.device
        out = torch.zeros((i.numel(), LANES), dtype=torch.int32, device=first)
        for d in range(self.n_shards):
            out += self._probe_local(d, i).to(first)
        return out

    def LF_all(self, i) -> torch.Tensor:
        return self.C[:LANES][None, :] + self.ranks_all(i)


def sharded_backward_search_blocked(index: ShardedFMIndex, patterns,
                                    lengths) -> np.ndarray:
    """Backward search against a block-sharded index (a host loop over the
    pattern characters, each step one sharded ranks_all).  patterns
    int[Q, max_len] of comp values, the first lengths[q] of row q read.
    Counts int64[Q]."""
    patterns = np.asarray(patterns, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    q, max_len = patterns.shape
    rows = np.arange(q)
    C = index.C.cpu().numpy().astype(np.int64)
    last = patterns[rows, lengths - 1]
    sp, ep = C[last], C[last + 1] - 1
    for t in range(max_len - 2, -1, -1):
        idx = lengths - 2 - (max_len - 2 - t)
        active = (idx >= 0) & (ep >= sp)
        c = patterns[rows, np.clip(idx, 0, max_len - 1)]
        ranks = index.ranks_all(np.concatenate([sp, ep + 1])).cpu().numpy()
        r_sp = ranks[:q][rows, c].astype(np.int64)
        r_ep = ranks[q:][rows, c].astype(np.int64)
        sp = np.where(active, C[c] + r_sp, sp)
        ep = np.where(active, C[c] + r_ep - 1, ep)
    return np.maximum(0, ep - sp + 1)


def wavefront_search_sharded(a_idx: ShardedFMIndex, b_idx: ShardedFMIndex,
                             b_sp0: int, b_ep0: int, a_sequences: int):
    """The trie search of B's sequence block [b_sp0, b_ep0] through A with
    both indexes block-sharded.  The frontier (a_pos, b_sp, b_ep) lives on
    the first mesh entry and advances one depth a step, every node expanded
    by the characters 1..SIGMA-1 through three sharded ranks_all; each
    depth emits (a_pos, b_ep - b_sp + 1) for its nodes, the root
    (a_sequences, [b_sp0, b_ep0]) included.  Returns the sorted-unique host
    rank array (values int64[T], counts int64[T]) and False: the JAX
    function's overflow flag, which a search without static capacities
    never raises."""
    dev = a_idx.C.device
    cs = torch.arange(1, SIGMA, device=dev)
    C_a = a_idx.C.to(torch.int64)[cs][None, :]
    C_b = b_idx.C.to(torch.int64)[cs][None, :]
    a_pos = torch.tensor([a_sequences], dtype=torch.int64, device=dev)
    b_sp = torch.tensor([b_sp0], dtype=torch.int64, device=dev)
    b_ep = torch.tensor([b_ep0], dtype=torch.int64, device=dev)
    values, counts = [], []
    while a_pos.numel() and bool((b_ep >= b_sp).any()):
        keep = b_ep >= b_sp
        a_pos, b_sp, b_ep = a_pos[keep], b_sp[keep], b_ep[keep]
        values.append(a_pos)
        counts.append(b_ep - b_sp + 1)
        rb_sp = b_idx.ranks_all(b_sp)[:, 1:SIGMA].to(torch.int64)
        rb_ep = b_idx.ranks_all(b_ep + 1)[:, 1:SIGMA].to(torch.int64)
        ra = a_idx.ranks_all(a_pos)[:, 1:SIGMA].to(torch.int64)
        csp, cep, ca = C_b + rb_sp, C_b + rb_ep - 1, C_a + ra
        live = cep >= csp
        a_pos, b_sp, b_ep = ca[live], csp[live], cep[live]
    if not values:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), False
    v, c = compact_pairs(torch.cat(values), torch.cat(counts))
    return v.cpu().numpy(), c.cpu().numpy(), False
