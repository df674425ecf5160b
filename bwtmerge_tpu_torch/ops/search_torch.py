"""Rank-array construction by wavefront search of the reverse trie, in
PyTorch.

Port of bwtmerge_tpu/ops/search_jax.py (the re-design of the reference's
reverse-trie DFS, buildRA, fmi.cpp:261-334).  The whole frontier advances
one trie depth per step:

    step:  F nodes (a_pos, b_sp, b_ep)
           -> ranks_all(B, sp), ranks_all(B, ep + 1), ranks_all(A, a_pos)
           -> [F, sigma-1] children, the non-empty ones are the new frontier

A node carries a whole lexicographic range of B's suffixes, so shared
prefixes advance in few nodes.  Each depth emits (a_pos, b_ep - b_sp + 1)
for every node before it expands; the emissions, sorted and summed per
value, are the rank array.  The search needs no read text, so it takes
every B: no sidecar, no reads, reads of any length.

Only the contract of the JAX search is ported.  Its static frontier and
emission capacities, overflow flags, capacity ladders and compaction sorts
answer XLA's static shapes; here a frontier has its true length and
compaction is a boolean mask.  The host reads the frontier's state once
per depth.

Each step exists twice.  The gather steps (expand_step, singles_step) read
one record row per query (DeviceFMIndex.ranks_all, LF_step).  The streamed
steps (expand_step_streamed, singles_step_streamed) sort their queries and
probe through the wrappers of the hand-written CUDA kernel K1
(rank_streamed.py): the range step through its full form, the singles step
through its lf form on B and its select form on A.  They are the default on
a CUDA device, the gather steps on the CPU (default_streamed).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.ranges import get_bounds
from .ra_stream import BlockedRA
from .rank_streamed import streamed_lf, streamed_probe, streamed_select
from .rank_torch import SIGMA, DeviceFMIndex

Frontier = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def default_streamed(device) -> bool:
    """True where the streamed steps are the default: on a CUDA device,
    where they launch kernel K1.  On the CPU the probe is its plain version,
    which gains nothing over the gathers."""
    return torch.device(device).type == "cuda"


def _c64(idx: DeviceFMIndex) -> torch.Tensor:
    """C[1..SIGMA-1] as int64: child positions are formed in int64, so
    C[c] + rank cannot wrap (an int32 rank added to it widens)."""
    return idx.C[1:SIGMA].to(torch.int64)


def _keys(q_sorted: torch.Tensor) -> torch.Tensor:
    """A non-decreasing int64 batch as K1's int32 keys."""
    return q_sorted.to(torch.int32).contiguous()


def _probe(idx: DeviceFMIndex, q_sorted: torch.Tensor) -> torch.Tensor:
    """The full form's ranks of characters 1..SIGMA-1 for a non-decreasing
    int64 batch: int32[SIGMA-1, Q]."""
    return streamed_probe(idx.rec, _keys(q_sorted), idx.size)[1:SIGMA]


# -- one depth step, range nodes ----------------------------------------------


def expand_step(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                a_pos: torch.Tensor, b_sp: torch.Tensor,
                b_ep: torch.Tensor) -> Frontier:
    """Expand every frontier node (int64[F] each) by the characters
    1..SIGMA-1 and keep the children whose B range is not empty:
    (child_a, child_sp, child_ep), int64[F'] each.  The multiset of
    children is the contract; their order is free.  Batched analog of the
    per-node child loops, fmi.cpp:296-321."""
    rb_sp = b_idx.ranks_all(b_sp)[:, 1:SIGMA].to(torch.int64)
    rb_ep = b_idx.ranks_all(b_ep + 1)[:, 1:SIGMA].to(torch.int64)
    ra = a_idx.ranks_all(a_pos)[:, 1:SIGMA].to(torch.int64)
    child_sp = _c64(b_idx)[None, :] + rb_sp                    # [F, SIGMA-1]
    child_ep = _c64(b_idx)[None, :] + rb_ep - 1
    child_a = _c64(a_idx)[None, :] + ra
    keep = child_ep >= child_sp
    return child_a[keep], child_sp[keep], child_ep[keep]


def expand_step_streamed(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                         a_pos: torch.Tensor, b_sp: torch.Tensor,
                         b_ep: torch.Tensor) -> Frontier:
    """expand_step computed with streamed probes; same contract.

    The probe wants a non-decreasing batch.  The nodes of one depth hold
    disjoint B ranges, so sorting them by b_sp also sorts b_ep + 1 and both
    B probes run with no realignment; only the A side is sorted on its own
    and put back by the inverse permutation.  b_ep + 1 may equal B's size,
    which the probe takes."""
    order = torch.argsort(b_sp)
    kb, eb, ab = b_sp[order], b_ep[order], a_pos[order]
    pb_sp = _probe(b_idx, kb)                                  # [SIGMA-1, F]
    pb_ep = _probe(b_idx, eb + 1)
    ka, ia = torch.sort(ab)
    ra = torch.empty_like(pb_sp)
    ra[:, ia] = _probe(a_idx, ka)                             # back to b order
    child_sp = _c64(b_idx)[:, None] + pb_sp
    child_ep = _c64(b_idx)[:, None] + pb_ep - 1
    child_a = _c64(a_idx)[:, None] + ra
    keep = child_ep >= child_sp
    return child_a[keep], child_sp[keep], child_ep[keep]


# -- one depth step, singleton nodes ------------------------------------------
#
# Deep in the search almost every node is a singleton (b_ep == b_sp).  A
# singleton has exactly one child, the character BWT_B[p] by one LF step,
# and needs two rank rows, not three, and no fan-out over the characters.
# A range node's children can be singletons but never the reverse, so the
# search runs the range steps until the whole frontier is singletons and the
# singles steps from there (the reference's node-size strategy switch,
# fmi.cpp:296-321).


def singles_step(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                 sa: torch.Tensor, spos: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One depth of an all-singleton frontier (sa, spos int64[F]: the A
    position and the B position of each node): (child_sa, child_spos) of
    the nodes whose B character is not the endmarker."""
    lf_b, c_b = b_idx.LF_step(spos)
    c_b = c_b.to(torch.int64)
    rows = a_idx.ranks_all(sa).to(torch.int64)
    child_a = a_idx.C.to(torch.int64)[c_b] + rows.gather(1, c_b[:, None])[:, 0]
    alive = c_b != 0
    return child_a[alive], lf_b.to(torch.int64)[alive]


def singles_step_streamed(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                          sa: torch.Tensor, spos: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """singles_step with probes in place of gathers.  It takes and returns
    the frontier with spos ascending, so the B probe needs no sort; the two
    sorts are by A position, for the A probe, and by child B position, to
    hand the next depth an ascending spos.  B's probe is K1's lf form (the
    symbol and its rank), A's its select form (the rank of that symbol)."""
    sym_b, rank_b = streamed_lf(b_idx.rec, _keys(spos), b_idx.size)
    alive = sym_b != 0
    c_b = sym_b[alive]                                         # int32
    lf_b = b_idx.C.to(torch.int64)[c_b] + rank_b[alive]
    ka, perm = torch.sort(sa[alive])
    lf_s, cb_s = lf_b[perm], c_b[perm]
    child_a = (a_idx.C.to(torch.int64)[cb_s]
               + streamed_select(a_idx.rec, _keys(ka), cb_s, a_idx.size))
    spos2, perm2 = torch.sort(lf_s)
    return child_a[perm2], spos2


# -- the two-phase search -----------------------------------------------------


def wavefront_search(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                     b_seq_range: Tuple[int, int], a_sequences: int,
                     streamed: Optional[bool] = None):
    """Search B's sequence block [sp0, ep0] (closed) through A.  Returns the
    raw emissions (values int64[E], counts int64[E]) on the indexes' device,
    unsorted: every depth's (a_pos, b_ep - b_sp + 1) of every node, the root
    (a_sequences, [sp0, ep0]) included (fmi.cpp:286-287).  An empty block
    (ep0 < sp0) emits nothing."""
    dev = a_idx.device
    if b_idx.device != dev:
        raise ValueError("wavefront_search: indexes on different devices")
    if streamed is None:
        streamed = default_streamed(dev)
    sp0, ep0 = b_seq_range
    values: List[torch.Tensor] = []
    counts: List[torch.Tensor] = []
    if ep0 < sp0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    a_pos = torch.tensor([a_sequences], dtype=torch.int64, device=dev)
    b_sp = torch.tensor([sp0], dtype=torch.int64, device=dev)
    b_ep = torch.tensor([ep0], dtype=torch.int64, device=dev)

    expand = expand_step_streamed if streamed else expand_step
    # range phase: until no node holds more than one suffix of B
    while a_pos.numel() and bool((b_ep > b_sp).any()):
        values.append(a_pos)
        counts.append(b_ep - b_sp + 1)
        a_pos, b_sp, b_ep = expand(a_idx, b_idx, a_pos, b_sp, b_ep)

    # singles phase: one child per node, the frontier only shrinks
    sa, spos = a_pos, b_sp
    if streamed:
        spos, order = torch.sort(spos)
        sa = sa[order]
    step = singles_step_streamed if streamed else singles_step
    while sa.numel():
        values.append(sa)
        counts.append(torch.ones_like(sa))
        sa, spos = step(a_idx, b_idx, sa, spos)
    return torch.cat(values), torch.cat(counts)


def compact_pairs(values: torch.Tensor, counts: torch.Tensor):
    """Sort raw emissions by value and sum the counts of equal values, on
    their device: sorted-unique (values int64[U], counts int64[U]).  The
    device form of search_np.compact_rank_array."""
    v, order = torch.sort(values)
    uv, inverse = torch.unique_consecutive(v, return_inverse=True)
    uc = torch.zeros_like(uv).index_add_(0, inverse, counts[order])
    return uv, uc


def search_block_runs(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                      b_seq_range: Tuple[int, int], a_sequences: int,
                      streamed: Optional[bool] = None):
    """One sequence block's rank array on the device: sorted-unique
    (values int64[U], counts int64[U])."""
    return compact_pairs(*wavefront_search(a_idx, b_idx, b_seq_range,
                                           a_sequences, streamed))


def blocked_search(a_idx: DeviceFMIndex, b_idx: DeviceFMIndex,
                   a_sequences: int, b_sequences: int, n_blocks: int,
                   streamed: Optional[bool] = None,
                   ra: Optional[BlockedRA] = None) -> BlockedRA:
    """Search B's sequences in `n_blocks` blocks (get_bounds), each reduced
    on the device and sent on its way to the host before the next block is
    searched, into `ra` (a BlockedRA that holds every block when None)."""
    ra = BlockedRA() if ra is None else ra
    for rng in get_bounds((0, b_sequences - 1), max(1, n_blocks)):
        ra.add(*search_block_runs(a_idx, b_idx, rng, a_sequences, streamed))
    return ra


def build_rank_array_torch(a, b, config, sequence_blocks: int = 1,
                           streamed: Optional[bool] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The whole rank array of B relative to A as sorted-unique host arrays
    (values int64[T], counts int64[T]): the counterpart of
    search_jax.build_rank_array_jax and search_np.build_rank_array.  `a`
    and `b` are FMIs; the search runs on config.device."""
    ra = blocked_search(a.device_index(config.device),
                        b.device_index(config.device), a.sequences(),
                        b.sequences(), sequence_blocks, streamed)
    return ra.finish()
