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
in place (one buffer for all lane slabs, no concatenation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import DECODE
from .rank_torch import LANES, REC, DeviceFMIndex
from .walk_torch import WALK_MAX_LEN

DECODE_SLAB_LANES = 4 * 1024 * 1024   # lanes per decode call


def _pow2_at_least(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


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
                         lane0: int = 0) -> torch.Tensor:
    """Decode lanes lane0 .. lane0+W-1 into creads int8[cap, W] (zeroed by
    the caller, rows lane-contiguous); returns the lanes alive after the
    last row (int64 scalar tensor).  CUDA tensors launch kernel K3; CPU
    tensors take decode_creads_plain."""
    rec = index.rec
    if rec.dtype != torch.int32 or rec.dim() != 2 or rec.shape[1] != REC:
        raise ValueError(f"rec must be int32[NBLK, {REC}], got "
                         f"{rec.dtype}{list(rec.shape)}")
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
    if rec.data_ptr() % 16:
        raise ValueError("decode needs a 16-byte aligned rec")
    cap, w = creads.shape
    n_alive = torch.zeros((), dtype=torch.int64, device=rec.device)
    if cap and w:
        with torch.cuda.device(rec.device):
            DECODE.launch(rec.data_ptr(), index.C.data_ptr(), int(lane0), w,
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
    buffer; rows are trimmed to the longest read."""
    top = _pow2_at_least(max_len_cap, 128)
    slab = DECODE_SLAB_LANES
    while True:
        creads = torch.zeros((cap, sequences), dtype=torch.int8,
                             device=index.device)
        over = [decode_creads_device(index, creads[:, s0:s0 + slab], s0)
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
