"""Carry index state across from the JAX package.

The JAX index (bwtmerge_tpu.ops.rank_jax.DeviceFMIndex) and the port's
share one layout, so its arrays, handed over as numpy, make a port index
without rebuilding from the runs.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import resolve_device
from .ops.rank_torch import BLK, LANES, REC, DeviceFMIndex


def index_from_arrays(rec, C, size: int, n_runs: int = 0,
                      device="cuda") -> DeviceFMIndex:
    """A port DeviceFMIndex from a JAX index's (rec, C, size, n_runs), with
    rec int32[>= size//32 + 1, 16] and C int32[9] as numpy arrays.  Rows of
    rec beyond size//32 + 1 (none in the JAX index) are dropped."""
    dev = resolve_device(device)
    rec = np.asarray(rec)
    C = np.asarray(C)
    nblk = int(size) // BLK + 1
    if rec.dtype != np.int32 or rec.ndim != 2 or rec.shape[1] != REC \
            or rec.shape[0] < nblk:
        raise ValueError(f"rec must be int32[>= {nblk}, {REC}], got "
                         f"{rec.dtype}{list(rec.shape)}")
    if C.shape != (LANES + 1,):
        raise ValueError(f"C must have {LANES + 1} entries")
    return DeviceFMIndex(
        rec=torch.from_numpy(np.array(rec[:nblk], dtype=np.int32)).to(dev),
        C=torch.from_numpy(C.astype(np.int32)).to(dev),
        size=int(size), n_runs=int(n_runs))
