"""Interleave two RLE BWTs by a rank array on a torch device.

Port of bwtmerge_tpu/ops/interleave_jax.py.  The reference's merge phase is
a sequential 2-thread producer/consumer walk of both RLE streams
(RABuffer/mergeRA/mergeBWT, bwt.cpp:152-314).  On a device the merge is
position arithmetic over prefix sums, fully parallel:

  output index of B position j = RA_expanded[j] + j
  output index of A position i = i + (# B positions whose RA value <= i)

Both sides are scatters; the merged symbol stream is materialized on the
device and run-length re-encoded from its run starts.  Both inputs are
decoded whole, so this serves inputs that fit the device decoded; the
native chain (native/api.py) stays the default.

Differences from the JAX module, none of them in the result: index tensors
are int64, so the 2^31-position bound of its int32 lanes is gone; the run
starts come from `torch.nonzero`, which gives the exact run count where the
JAX program needed a static capacity of n_out; and because an index out of
range is a device-side assert on CUDA (JAX's mode="drop" scatters drop it
in silence), interleave_torch checks the rank array on the host before any
scatter and raises ValueError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import resolve_device
from ..models.runs import RunArrays


def _interleave_decoded(a_vals: torch.Tensor, b_vals: torch.Tensor,
                        ra_values: torch.Tensor, ra_counts: torch.Tensor
                        ) -> torch.Tensor:
    """Merged plain symbol stream (uint8[n_a + n_b]) from decoded inputs
    and a rank array (int64 values ascending, int64 counts summing to n_b,
    values within [0, n_a]: the caller checks)."""
    n_a, n_b = a_vals.numel(), b_vals.numel()
    device = a_vals.device
    out = torch.zeros(n_a + n_b, dtype=torch.uint8, device=device)
    if n_b == 0:
        out[:] = a_vals
        return out

    # B side: expand (value, count) runs to per-position RA values; B's
    # position j lands at ra_expanded[j] + j
    ra_exp = torch.repeat_interleave(ra_values, ra_counts, output_size=n_b)
    j = torch.arange(n_b, dtype=torch.int64, device=device)
    out[ra_exp + j] = b_vals
    del ra_exp, j

    # A side: shift each position by the count of B positions whose RA
    # value is <= it
    cum = torch.cumsum(ra_counts, dim=0)
    i = torch.arange(n_a, dtype=torch.int64, device=device)
    k = torch.searchsorted(ra_values, i, right=True)
    shift = torch.where(k > 0, cum[torch.clamp(k - 1, min=0)], 0)
    out[i + shift] = a_vals
    return out


def _rle_encode_device(vals: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Run-length encoding by boundary detection: (syms uint8[n_runs], ends
    int64[n_runs], n_runs); ends[r] is the exclusive end position of run r,
    lens are the differences of ends.  `vals` is not empty."""
    n = vals.numel()
    is_start = torch.ones(n, dtype=torch.bool, device=vals.device)
    is_start[1:] = vals[1:] != vals[:-1]
    starts = torch.nonzero(is_start).reshape(-1)
    n_runs = starts.numel()
    ends = torch.empty(n_runs, dtype=torch.int64, device=vals.device)
    ends[:-1] = starts[1:]
    ends[-1] = n
    return vals[starts], ends, n_runs


def rle_runs_device(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(syms uint8[n_runs], lens int64[n_runs]) of a symbol stream on its
    device: _rle_encode_device with the run lengths taken there too, so the
    host receives run arrays and makes no pass over positions."""
    syms, ends, _ = _rle_encode_device(vals)
    lens = ends.clone()
    lens[1:] -= ends[:-1]
    return syms, lens


def _check_rank_array(ra_values: np.ndarray, ra_counts: np.ndarray,
                      n_a: int, n_b: int) -> None:
    total = int(np.sum(ra_counts, dtype=np.int64))
    if total != n_b:
        raise ValueError(
            f"rank array covers {total} values, expected {n_b}")
    if ra_values.shape != ra_counts.shape:
        raise ValueError("rank array values and counts differ in length")
    if ra_values.size and (int(ra_values.min()) < 0
                           or int(ra_values.max()) > n_a
                           or int(ra_counts.min()) < 0):
        raise ValueError(
            f"rank array inconsistent with inputs: values must lie in "
            f"[0, {n_a}] and counts must not be negative")
    if ra_values.size > 1 and not bool(np.all(ra_values[1:]
                                              >= ra_values[:-1])):
        raise ValueError("rank array values must ascend")


def interleave_torch(a: RunArrays, b: RunArrays, ra_values: np.ndarray,
                     ra_counts: np.ndarray, device="cuda",
                     stats: Optional[dict] = None) -> RunArrays:
    """Device interleave producing a host RunArrays.

    For inputs that fit the device decoded; larger merges stream through
    the native C++ interleave (native/api.py).  A rank array that does not
    fit the inputs raises ValueError before anything runs on the device.
    `stats`, when given, receives the seconds of the two device programs
    (synchronised): interleave_s and rle_s.
    """
    import time

    n_a, n_b = a.size(), b.size()
    ra_values = np.ascontiguousarray(ra_values, dtype=np.int64)
    ra_counts = np.ascontiguousarray(ra_counts, dtype=np.int64)
    _check_rank_array(ra_values, ra_counts, n_a, n_b)
    if n_a + n_b == 0:
        return RunArrays.empty()
    dev = resolve_device(device)

    def sync():
        if stats is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.monotonic()

    a_vals = torch.from_numpy(a.decode()).to(dev)
    b_vals = torch.from_numpy(b.decode()).to(dev)
    rv = torch.from_numpy(ra_values).to(dev)
    rc = torch.from_numpy(ra_counts).to(dev)
    t0 = sync()
    out = _interleave_decoded(a_vals, b_vals, rv, rc)
    t1 = sync()
    syms, lens = rle_runs_device(out)
    t2 = sync()
    if stats is not None:
        stats.update(interleave_s=t1 - t0, rle_s=t2 - t1)
    return RunArrays(syms.cpu().numpy(), lens.cpu().numpy())


def interleave_offsets(ra_values: np.ndarray, ra_counts: np.ndarray,
                       n_a: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: per-RA-run output offsets for both inputs.

    For streaming writers: B's k-th RA run of c positions lands at output
    offset ra_values[k] + cum_counts[k-1]; the A segment between consecutive
    RA values keeps its order shifted by cum_counts.  (The prefix-sum view of
    the interleaving bitvector, paper.tex:166.)
    """
    cum = np.zeros(ra_counts.size + 1, dtype=np.int64)
    np.cumsum(ra_counts, out=cum[1:])
    b_out_start = ra_values + cum[:-1]
    return b_out_start, cum
