"""The big-piece tier's inserts: six ~510 Mbp native files, each the k-way
fold of five cached 102 Mbp pieces.

Port of the JAX tree's `scripts/build_big_pieces.py`, with its GROUPS.
Fewer, bigger pieces carry the same bases with less walk work: a fold of K
pieces walks each piece through every earlier one, so its walks grow as
K^2 / 2 times a piece's reads.  The files have no `.reads4` sidecar, so a
fold over them decodes each one's 10,000,000 reads on the device (K3 and
its decode rows).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from .fixtures import READS, build_piece, default_cache, measured, piece_path

GROUPS: Dict[str, Sequence[int]] = {
    "xl_big_1": (201, 202, 203, 204, 205),
    "xl_big_2": (205, 206, 207, 208, 209),
    "xl_big_3": (203, 204, 205, 206, 207),
    "xl_big_4": (209, 208, 202, 201, 204),
    "xl_big_5": (202, 204, 206, 208, 209),
    "xl_big_6": (201, 203, 205, 207, 209),
}


def big_path(cache: str, name: str, reads: int = READS) -> str:
    return os.path.join(cache, f"{name}_{reads}.native")


def build(cache: Optional[str] = None, reads: int = READS, device="cuda",
          groups: Dict[str, Sequence[int]] = GROUPS,
          steps: Optional[list] = None) -> List[str]:
    """Each group's fold (models/kfold.merge_files_many, SGA pieces into a
    native file) on `device`, its pieces built first where missing;
    cached.  The big pieces' paths, in the groups' order."""
    from ..kernels import resolve_device
    from ..models.kfold import merge_files_many
    from ..models.merge import MergeConfig

    device = resolve_device(device)
    cache = cache or default_cache()
    out = []
    for name, seeds in groups.items():
        path = big_path(cache, name, reads)
        out.append(path)
        if os.path.exists(path):
            continue
        for seed in seeds:
            build_piece(cache, seed, reads, device, steps)
        with measured(steps, name, device) as rec:
            merge_files_many([piece_path(cache, s, reads) for s in seeds],
                             path, "sga", "native",
                             MergeConfig(device=str(device), temp_dir=cache))
            rec["MB"] = os.path.getsize(path) / 1e6
    return out

