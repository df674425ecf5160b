"""Device read decode: B's reads recovered from its own BWT, in PyTorch.

Port of the decode half of bwtmerge_tpu/ops/walk_jax.py
(decode_creads_device, _decode_step, decode_creads_dev, decode_creads).
Lane r chases LF from BWT row lane0 + r: rows [0, sequences) are the
endmarker rows, so the first step yields the read's LAST character and the
rows come out in the walk's end-aligned layout (int8[max_len, R], 0 past a
read's start).  A lane dies at the endmarker; lanes still alive after the
last row belong to reads longer than the cap.

`decode_creads_device` is the wrapper of the hand-written CUDA kernel K3
(csrc/decode.cu); `decode_creads_plain` is its plain PyTorch version, which
the wrapper takes for CPU tensors.  Both fill a caller-zeroed creads buffer
in place (one buffer for all lane slabs, no concatenation).  K3 reads the
decode rows, one 32-byte row per block (five occ counts and three bit-planes
of the block's symbols): `build_decode_rows` is the wrapper of the kernel
that builds them, in the same source, `build_decode_rows_plain` its plain
version and `decode_rows_step` one LF step over them in plain PyTorch.  The plain decode
goes through the record table (`LF_step`), independent of the rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import DECODE, DECODE_ROWS_BUILD
from .rank_torch import (BLK, LANES, SIGMA, DeviceFMIndex, check_rec,
                         unpack_symbols)
from .walk_torch import WALK_MAX_LEN, _int32_wrap, _popcount32

ROW_WORDS = 8    # int32 words per decode row: 5 occ counts + 3 bit-planes
N_OCC = SIGMA - 1

DECODE_SLAB_LANES = 4 * 1024 * 1024   # lanes per decode call


def _pow2_at_least(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def build_decode_rows_plain(rec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the decode rows: int32[NBLK, 8], row b =
    [occ of c = 1..5 before block b | planes 0..2], bit j of plane k = bit
    k of the symbol at position 32*b + j."""
    syms = unpack_symbols(rec[:, LANES:])                      # [NBLK, 32]
    bit = torch.ones(BLK, dtype=torch.int64, device=rec.device) << torch.arange(
        BLK, device=rec.device)
    planes = [_int32_wrap((((syms >> k) & 1) * bit).sum(dim=1))
              for k in range(ROW_WORDS - N_OCC)]
    return torch.cat([rec[:, 1:1 + N_OCC], torch.stack(planes, dim=1)],
                     dim=1).contiguous()


def build_decode_rows(rec: torch.Tensor) -> torch.Tensor:
    """The decode's table from the record table: int32[NBLK, 8] (see
    build_decode_rows_plain).  CUDA tensors launch decode_rows_build of
    csrc/decode.cu; CPU tensors take the plain version."""
    check_rec(rec, "build_decode_rows")
    if rec.device.type == "cpu":
        return build_decode_rows_plain(rec)
    if rec.device.type != "cuda":
        raise ValueError(f"build_decode_rows: unsupported device {rec.device}")
    if not rec.is_contiguous() or rec.data_ptr() % 16:
        raise ValueError("build_decode_rows needs a contiguous, 16-byte "
                         "aligned rec")
    rows = torch.empty((rec.shape[0], ROW_WORDS), dtype=torch.int32,
                       device=rec.device)
    with torch.cuda.device(rec.device):
        DECODE_ROWS_BUILD.launch(rec.data_ptr(), rec.shape[0],
                                 rows.data_ptr())
    return rows


def decode_rows_step(rows: torch.Tensor, C: torch.Tensor, p: torch.Tensor):
    """One step of K3 in plain PyTorch: (LF(p), BWT[p]) as int64[Q] from the
    decode rows alone, for positions p holding a symbol 0..5 (LF of an
    endmarker position is C[0] plus the endmarkers before the block's
    start, which the rows do not hold: only its symbol is meaningful)."""
    p = p.to(torch.int64)
    row = rows[p >> 5].to(torch.int64) & 0xFFFFFFFF            # [Q, 8]
    off = p & (BLK - 1)
    bits = [(row[:, N_OCC + k] >> off) & 1 for k in range(3)]
    sym = bits[0] | (bits[1] << 1) | (bits[2] << 2)
    match = torch.full_like(p, 0xFFFFFFFF)
    for k in range(3):
        plane = row[:, N_OCC + k]
        match = match & torch.where(bits[k] == 1, plane, plane ^ 0xFFFFFFFF)
    before = _popcount32(match & ((torch.ones_like(p) << off) - 1))
    occ = torch.cat([torch.zeros_like(row[:, :1]), row[:, :N_OCC],
                     torch.zeros_like(row[:, :2])], dim=1)     # by symbol
    lf = C.to(torch.int64)[sym] + occ.gather(1, sym[:, None])[:, 0] + before
    return lf, sym


def decode_creads_plain(index: DeviceFMIndex, creads: torch.Tensor,
                        lane0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the decode: fills creads int8[cap, W]
    (zeroed by the caller; may be a column slice of a wider buffer) for lanes
    lane0 .. lane0+W-1 and returns the count of lanes alive after the last
    row (int64 scalar tensor)."""
    cap, w = creads.shape
    p = lane0 + torch.arange(w, dtype=torch.int64, device=creads.device)
    alive = p < index.C[1].to(torch.int64)
    for t in range(cap):
        if not bool(alive.any()):
            break
        lf, sym = index.LF_step(torch.where(alive, p, 0))
        sym = torch.where(alive, sym, 0)
        creads[t] = sym.to(torch.int8)
        alive = alive & (sym > 0)
        p = torch.where(alive, lf.to(torch.int64), p)
    return alive.sum(dtype=torch.int64)


def decode_creads_device(index: DeviceFMIndex, creads: torch.Tensor,
                         lane0: int = 0,
                         rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode lanes lane0 .. lane0+W-1 into creads int8[cap, W] (zeroed by
    the caller, rows lane-contiguous); returns the lanes alive after the
    last row (int64 scalar tensor).  CUDA tensors launch kernel K3 over
    `rows`, the index's decode rows (built here when not given; a caller
    with several slabs or caps builds them once); CPU tensors take
    decode_creads_plain."""
    rec = index.rec
    check_rec(rec, "decode")
    if index.C.dtype != torch.int32 or index.C.shape != (LANES + 1,):
        raise ValueError(f"C must be int32[{LANES + 1}]")
    if creads.dtype != torch.int8 or creads.dim() != 2:
        raise ValueError(f"creads must be int8[cap, W], got "
                         f"{creads.dtype}{list(creads.shape)}")
    if not (rec.device == index.C.device == creads.device):
        raise ValueError("decode: tensors on different devices")
    if lane0 < 0:
        raise ValueError(f"lane0 {lane0} is negative")
    if rec.device.type == "cpu":
        return decode_creads_plain(index, creads, lane0)
    if rec.device.type != "cuda":
        raise ValueError(f"decode: unsupported device {rec.device}")
    if not (rec.is_contiguous() and index.C.is_contiguous()):
        raise ValueError("decode needs a contiguous record table and C")
    if creads.shape[1] > 1 and creads.stride(1) != 1:
        raise ValueError("decode needs lane-contiguous creads rows")
    if rows is None:
        rows = build_decode_rows(rec)
    if rows.dtype != torch.int32 or rows.shape != (rec.shape[0], ROW_WORDS) \
            or rows.device != rec.device or not rows.is_contiguous() \
            or rows.data_ptr() % 32:
        raise ValueError(f"rows must be the index's decode rows, contiguous "
                         f"32-byte aligned int32[{rec.shape[0]}, "
                         f"{ROW_WORDS}] on {rec.device}")
    cap, w = creads.shape
    n_alive = torch.zeros((), dtype=torch.int64, device=rec.device)
    if cap and w:
        with torch.cuda.device(rec.device):
            DECODE.launch(rows.data_ptr(), index.C.data_ptr(), int(lane0), w,
                          cap, creads.stride(0), creads.data_ptr(),
                          n_alive.data_ptr())
    return n_alive


def rows_used(creads: torch.Tensor) -> int:
    """1 + the last row holding any character (at least 1)."""
    live = (creads != 0).any(dim=1).nonzero()
    return max(int(live[-1, 0]) + 1 if live.numel() else 0, 1)


def _decode_capped(index: DeviceFMIndex, sequences: int, cap: int,
                   max_len_cap: int) -> Optional[torch.Tensor]:
    """Decode every read with row cap `cap`, doubling it (bucketed to a
    power of two, at most that of max_len_cap) while some read outlives it;
    None once a cap of max_len_cap or more still does not hold every read.
    The same cap sequence as walk_jax.decode_creads(_dev).  Lanes go in
    slabs of DECODE_SLAB_LANES, each written into its columns of one
    buffer; rows are trimmed to the longest read.  On a card the decode
    rows are built once, before the first cap, and freed on return."""
    top = _pow2_at_least(max_len_cap, 128)
    slab = DECODE_SLAB_LANES
    rows = (build_decode_rows(index.rec) if index.device.type == "cuda"
            else None)
    while True:
        creads = torch.zeros((cap, sequences), dtype=torch.int8,
                             device=index.device)
        over = [decode_creads_device(index, creads[:, s0:s0 + slab], s0, rows)
                for s0 in range(0, sequences, slab)]
        if int(torch.stack(over).sum()) == 0:
            return creads[: rows_used(creads)].contiguous()
        del creads
        if cap >= max_len_cap:
            return None
        cap = min(_pow2_at_least(cap * 2, 128), top)


def decode_creads_dev(index: DeviceFMIndex, sequences: int, size: int,
                      max_len_cap: int = WALK_MAX_LEN
                      ) -> Optional[Tuple[torch.Tensor, int]]:
    """All reads of `index` decoded on its device: (creads int8[max_len, R]
    with R = sequences, sequences), or None when some read outlives the
    caps (see _decode_capped).  The cap starts near the average read
    length."""
    if sequences <= 0:
        return torch.zeros((1, 0), dtype=torch.int8, device=index.device), 0
    avg = max(1, size // sequences)
    cap = min(_pow2_at_least(avg + avg // 4 + 16, 64),
              _pow2_at_least(max_len_cap, 128))
    creads = _decode_capped(index, sequences, cap, max_len_cap)
    return None if creads is None else (creads, sequences)


def decode_creads(index: DeviceFMIndex, sequences: int, size: int,
                  max_len_cap: int = WALK_MAX_LEN) -> Optional[np.ndarray]:
    """Host wrapper: creads np.int8[max_len, sequences] (end-aligned walk
    layout), or None when some read outlives the caps.  The cap starts at
    four times the average read length, as walk_jax.decode_creads."""
    if sequences <= 0:
        return np.zeros((0, 0), np.int8)
    avg = max(1, size // sequences)
    cap = min(_pow2_at_least(4 * avg + 64, 64),
              _pow2_at_least(max_len_cap, 128))
    creads = _decode_capped(index, sequences, cap, max_len_cap)
    return None if creads is None else creads.cpu().numpy()
