"""Streamed-rank probe for sorted query batches, and the search built on it.

Port of bwtmerge_tpu/ops/rank_pallas.py.  `streamed_probe` is the wrapper
of the hand-written CUDA kernel K1 (csrc/streamed_probe.cu), which replaces
the Pallas kernel rank_pallas._kernel; `streamed_probe_plain` is its plain
PyTorch version, which the wrapper takes for CPU tensors.

backward_search_streamed keeps the JAX algorithm: per step the 2Q range
ends are sorted (carrying their lane and character), probed in one batch,
the rank of each end's character selected, and the ranks realigned to
their lanes.
"""

from __future__ import annotations

import torch

from ..kernels import STREAMED_PROBE
from .rank_torch import LANES, REC, SENT, DeviceFMIndex, probe_rows

OUT_W = 16        # output rows: LANES ranks, the symbol at q, zero padding


def streamed_probe_plain(rec: torch.Tensor, q: torch.Tensor,
                         size: int) -> torch.Tensor:
    """Plain PyTorch version of the probe: int32[OUT_W, Q].  Rows 0-7 are
    rank(q, c), row 8 the symbol at q, rows 9-15 zero; every row is zero
    for q outside [0, size]."""
    qq = q.to(torch.int64)
    valid = (qq >= 0) & (qq <= size)
    occ, syms, before, off = probe_rows(rec, torch.where(valid, qq, 0))
    out = torch.zeros((OUT_W, q.shape[0]), dtype=torch.int32,
                      device=rec.device)
    for c in range(LANES):
        out[c] = occ[:, c] + ((syms == c) & before).sum(dim=1,
                                                         dtype=torch.int32)
    out[LANES] = syms.gather(1, off[:, None])[:, 0].to(torch.int32)
    return out * valid.to(torch.int32)[None, :]


def streamed_probe(rec: torch.Tensor, q_sorted: torch.Tensor,
                   size: int) -> torch.Tensor:
    """int32[OUT_W, Q] for a non-decreasing int32 batch q_sorted (positions
    in [0, size], trailing 2^31-1 sentinels allowed).  CUDA tensors launch
    kernel K1; CPU tensors take streamed_probe_plain."""
    if rec.dtype != torch.int32 or rec.dim() != 2 or rec.shape[1] != REC:
        raise ValueError(f"rec must be int32[NBLK, {REC}], got "
                         f"{rec.dtype}{list(rec.shape)}")
    if q_sorted.dtype != torch.int32 or q_sorted.dim() != 1:
        raise ValueError(f"q_sorted must be int32[Q], got "
                         f"{q_sorted.dtype}{list(q_sorted.shape)}")
    if q_sorted.device != rec.device:
        raise ValueError("rec and q_sorted are on different devices")
    if not 0 <= size < 32 * rec.shape[0]:
        raise ValueError(f"size {size} outside the record table")
    if rec.device.type == "cpu":
        return streamed_probe_plain(rec, q_sorted, size)
    if rec.device.type != "cuda":
        raise ValueError(f"streamed_probe: unsupported device {rec.device}")
    if not (rec.is_contiguous() and q_sorted.is_contiguous()):
        raise ValueError("streamed_probe needs contiguous tensors")
    if rec.data_ptr() % 16:
        raise ValueError("streamed_probe needs a 16-byte aligned rec")
    n = q_sorted.shape[0]
    out = torch.empty((OUT_W, n), dtype=torch.int32, device=rec.device)
    if n:
        with torch.cuda.device(rec.device):
            STREAMED_PROBE.launch(rec.data_ptr(), q_sorted.data_ptr(), n,
                                  size, out.data_ptr())
    return out


def streamed_ranks_all(index: DeviceFMIndex,
                       q_sorted: torch.Tensor) -> torch.Tensor:
    """ranks_all for a sorted query batch: int32[Q, LANES]."""
    return streamed_probe(index.rec, q_sorted.to(torch.int32),
                          index.size)[:LANES].T


def ranks_all_unsorted(index: DeviceFMIndex, q: torch.Tensor) -> torch.Tensor:
    """Sort -> streamed probe -> unpermute."""
    order = torch.argsort(q)
    ans = streamed_ranks_all(index, q[order])
    out = torch.empty_like(ans)
    out[order] = ans
    return out


def backward_search_streamed(index: DeviceFMIndex, patterns: torch.Tensor,
                             lengths: torch.Tensor, max_len: int):
    """Batched backward search with the streamed probe; same contract as
    rank_torch.backward_search.  The pattern matrix stays in its dtype and
    is read one character a row a step; the rest of a step's state is a
    few vectors of Q or 2Q and K1's int32[OUT_W, 2Q] output."""
    lens = lengths.to(torch.int64)
    q = patterns.shape[0]
    rows = torch.arange(q, device=patterns.device)
    C = index.C.to(torch.int64)
    last = patterns[rows, lens - 1].to(torch.int64)
    sp = C[last]
    ep = C[last + 1] - 1
    lane2 = torch.arange(2 * q, device=patterns.device)
    for t in range(max_len - 1):
        idx = lens - 2 - t
        active = (idx >= 0) & (ep >= sp)
        c = patterns[rows, idx.clamp(0, max_len - 1)].to(torch.int64)
        c2 = torch.cat([c, c]).clamp(0, LANES - 1)
        key = torch.where(torch.cat([active, active]),
                          torch.cat([sp, ep + 1]), SENT).to(torch.int32)
        ks, perm = torch.sort(key)
        pr = streamed_probe(index.rec, ks, index.size)
        rk_sorted = pr[c2[perm], lane2]
        rk = torch.empty_like(rk_sorted)
        rk[perm] = rk_sorted                                   # realign
        rk = rk.to(torch.int64)
        sp = torch.where(active, C[c] + rk[:q], sp)
        ep = torch.where(active, C[c] + rk[q:] - 1, ep)
    return sp.to(torch.int32), ep.to(torch.int32)
