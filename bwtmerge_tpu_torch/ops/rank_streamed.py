"""Streamed-rank probe for sorted query batches, and the search built on it.

Port of bwtmerge_tpu/ops/rank_pallas.py.  The hand-written CUDA kernel K1
(csrc/streamed_probe.cu) replaces the Pallas kernel rank_pallas._kernel in
three forms, each writing only what its callers read; each has a wrapper
and a plain PyTorch version, which the wrapper takes for CPU tensors:

  streamed_probe   full: int32[OUT_W, Q], the 8 ranks and the symbol
  streamed_select  one rank a key, of a character given beside it,
                   optionally written back through the sort's permutation
  streamed_lf      int32[2, Q], the symbol at q and its rank (an LF step)

backward_search_streamed keeps the JAX algorithm: per step the 2Q range
ends are sorted, probed in one batch, and each end's rank of its character
put back in its lane; here the select form does the last two in its launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import STREAMED_PROBE
from .rank_torch import LANES, REC, SENT, DeviceFMIndex, probe_rows

# Rows of the full form: LANES ranks and the symbol at q.  The JAX package
# pads its output to 16 rows (rank_pallas.OUT_W), the TPU's sublane tile;
# those 7 rows are always zero and no caller reads them, so K1 stores none.
OUT_W = LANES + 1
FORMS = {"full": 0, "select": 1, "lf": 2}         # csrc/streamed_probe.cu
CHAR_TYPES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
              torch.int64: 4}


def _live_rows(rec: torch.Tensor, q: torch.Tensor, size: int):
    """probe_rows of each q, with q outside [0, size] read as 0: (live
    int32[Q], occ, syms, before, off)."""
    qq = q.to(torch.int64)
    live = (qq >= 0) & (qq <= size)
    return (live.to(torch.int32),
            *probe_rows(rec, torch.where(live, qq, 0)))


def _rank_of(occ, syms, before, c: torch.Tensor) -> torch.Tensor:
    """rank(q, c) of each row for c int64[Q] in [0, LANES): int32[Q]."""
    return (occ.gather(1, c[:, None])[:, 0]
            + ((syms == c[:, None]) & before).sum(dim=1, dtype=torch.int32))


def streamed_probe_plain(rec: torch.Tensor, q: torch.Tensor,
                         size: int) -> torch.Tensor:
    """Plain PyTorch version of the full form: int32[OUT_W, Q].  Rows 0-7
    are rank(q, c), row 8 the symbol at q; every row is zero for q outside
    [0, size]."""
    live, occ, syms, before, off = _live_rows(rec, q, size)
    out = torch.empty((OUT_W, q.shape[0]), dtype=torch.int32,
                      device=rec.device)
    for c in range(LANES):
        out[c] = occ[:, c] + ((syms == c) & before).sum(dim=1,
                                                         dtype=torch.int32)
    out[LANES] = syms.gather(1, off[:, None])[:, 0].to(torch.int32)
    return out * live[None, :]


def streamed_select_plain(rec: torch.Tensor, q: torch.Tensor,
                          chars: torch.Tensor, size: int,
                          perm: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the select form: int32[Q], rank(q[i],
    clamp(chars[i], 0, 7)), 0 for q outside [0, size].  With perm, chars
    are in the caller's order and the ranks are put back in it:
    out[perm[i]] = rank(q[i], chars[perm[i]])."""
    c = chars if perm is None else chars[perm]
    live, occ, syms, before, _ = _live_rows(rec, q, size)
    rk = _rank_of(occ, syms, before,
                  c.to(torch.int64).clamp(0, LANES - 1)) * live
    if perm is None:
        return rk
    out = torch.empty_like(rk)
    out[perm] = rk
    return out


def streamed_lf_plain(rec: torch.Tensor, q: torch.Tensor,
                      size: int) -> torch.Tensor:
    """Plain PyTorch version of the lf form: int32[2, Q], the symbol s at q
    and rank(q, clamp(s, 0, 7)); both 0 for q outside [0, size]."""
    live, occ, syms, before, off = _live_rows(rec, q, size)
    sym = syms.gather(1, off[:, None])[:, 0]
    rk = _rank_of(occ, syms, before, sym.clamp(0, LANES - 1))
    return torch.stack([sym.to(torch.int32), rk]) * live[None, :]


def _check(rec: torch.Tensor, q_sorted: torch.Tensor, size: int,
           name: str) -> bool:
    """Raise on what K1 does not take; True for CUDA tensors (launch the
    kernel), False for CPU tensors (take the plain version)."""
    if rec.dtype != torch.int32 or rec.dim() != 2 or rec.shape[1] != REC:
        raise ValueError(f"{name}: rec must be int32[NBLK, {REC}], got "
                         f"{rec.dtype}{list(rec.shape)}")
    if q_sorted.dtype != torch.int32 or q_sorted.dim() != 1:
        raise ValueError(f"{name}: q_sorted must be int32[Q], got "
                         f"{q_sorted.dtype}{list(q_sorted.shape)}")
    if q_sorted.device != rec.device:
        raise ValueError(f"{name}: rec and q_sorted are on different devices")
    if not 0 <= size < 32 * rec.shape[0]:
        raise ValueError(f"{name}: size {size} outside the record table")
    if rec.device.type == "cpu":
        return False
    if rec.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rec.device}")
    if not (rec.is_contiguous() and q_sorted.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    if rec.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned rec")
    return True


def _launch(form: str, rec, q_sorted, size: int, out, chars=None,
            perm=None) -> torch.Tensor:
    n = q_sorted.shape[0]
    if n:
        with torch.cuda.device(rec.device):
            STREAMED_PROBE.launch(
                rec.data_ptr(), q_sorted.data_ptr(), n, size, FORMS[form],
                None if chars is None else chars.data_ptr(),
                0 if chars is None else CHAR_TYPES[chars.dtype],
                None if perm is None else perm.data_ptr(), out.data_ptr(),
                form=form)
    return out


def streamed_probe(rec: torch.Tensor, q_sorted: torch.Tensor,
                   size: int) -> torch.Tensor:
    """The full form: int32[OUT_W, Q] for a non-decreasing int32 batch
    q_sorted (positions in [0, size], trailing 2^31-1 sentinels allowed).
    CUDA tensors launch kernel K1; CPU tensors take streamed_probe_plain."""
    if not _check(rec, q_sorted, size, "streamed_probe"):
        return streamed_probe_plain(rec, q_sorted, size)
    return _launch("full", rec, q_sorted, size, torch.empty(
        (OUT_W, q_sorted.shape[0]), dtype=torch.int32, device=rec.device))


def streamed_select(rec: torch.Tensor, q_sorted: torch.Tensor,
                    chars: torch.Tensor, size: int,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The select form: int32[Q], the rank of each key's character (chars,
    int[Q] of any integer dtype K1 takes, clamped to [0, 7]), 0 for keys
    outside [0, size].  chars lie beside the sorted keys, or, given perm
    (int64[Q], the permutation that sorted the keys), in the caller's
    order, and the ranks are returned in that order.  CUDA tensors launch
    kernel K1; CPU tensors take streamed_select_plain."""
    cuda = _check(rec, q_sorted, size, "streamed_select")
    n = q_sorted.shape[0]
    if chars.dtype not in CHAR_TYPES or chars.shape != (n,):
        raise ValueError(f"streamed_select: chars must be an integer "
                         f"tensor of shape [{n}], got "
                         f"{chars.dtype}{list(chars.shape)}")
    if perm is not None and (perm.dtype != torch.int64
                             or perm.shape != (n,)):
        raise ValueError(f"streamed_select: perm must be int64[{n}], got "
                         f"{perm.dtype}{list(perm.shape)}")
    for t in (chars, perm):
        if t is not None and t.device != rec.device:
            raise ValueError("streamed_select: rec, chars and perm are on "
                             "different devices")
    if not cuda:
        return streamed_select_plain(rec, q_sorted, chars, size, perm)
    if not (chars.is_contiguous() and (perm is None or perm.is_contiguous())):
        raise ValueError("streamed_select needs contiguous tensors")
    return _launch("select", rec, q_sorted, size,
                   torch.empty(n, dtype=torch.int32, device=rec.device),
                   chars, perm)


def streamed_lf(rec: torch.Tensor, q_sorted: torch.Tensor,
                size: int) -> torch.Tensor:
    """The lf form: int32[2, Q], the symbol at each key and its rank.  CUDA
    tensors launch kernel K1; CPU tensors take streamed_lf_plain."""
    if not _check(rec, q_sorted, size, "streamed_lf"):
        return streamed_lf_plain(rec, q_sorted, size)
    return _launch("lf", rec, q_sorted, size, torch.empty(
        (2, q_sorted.shape[0]), dtype=torch.int32, device=rec.device))


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
    few vectors of Q or 2Q.  K1's select form reads each end's character
    through the sort's permutation and writes its rank back to the end's
    lane, so the step gathers and scatters nothing itself."""
    lens = lengths.to(torch.int64)
    q = patterns.shape[0]
    rows = torch.arange(q, device=patterns.device)
    C = index.C.to(torch.int64)
    last = patterns[rows, lens - 1].to(torch.int64)
    sp = C[last]
    ep = C[last + 1] - 1
    for t in range(max_len - 1):
        idx = lens - 2 - t
        active = (idx >= 0) & (ep >= sp)
        c = patterns[rows, idx.clamp(0, max_len - 1)]
        key = torch.where(torch.cat([active, active]),
                          torch.cat([sp, ep + 1]), SENT).to(torch.int32)
        ks, perm = torch.sort(key)
        rk = streamed_select(index.rec, ks, torch.cat([c, c]), index.size,
                             perm)
        cq = C[c.to(torch.int64)]
        sp = torch.where(active, cq + rk[:q], sp)
        ep = torch.where(active, cq + rk[q:] - 1, ep)
    return sp.to(torch.int32), ep.to(torch.int32)
