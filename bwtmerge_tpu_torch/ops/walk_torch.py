"""Rank-array construction by per-read backward walk, in PyTorch.

Port of bwtmerge_tpu/ops/walk_jax.py (see its docstring for why the walk's
emissions are the rank-array multiset).  Every read of B is walked
backward through A only: lane r starts at a = A.sequences() and at each
character c of the read, counted from its end, steps to
a = C[c] + rank_A(a, c) and emits a.  The rank of a KNOWN character is one
32-byte row of the wide planes (build_walk_planes): the occ count before a
super-block of 224 positions and seven 32-bit masks of its positions
holding the character.

`walk_emit` is the wrapper of the hand-written CUDA kernel K2
(csrc/walk.cu), which replaces walk_jax._walk_emit; `walk_emit_plain` is
its plain PyTorch version, which the wrapper takes for CPU tensors.
`build_walk_planes` is the wrapper of the kernel that builds the table, in
the same source, `build_walk_planes_plain` its plain version.
`build_cplanes` and `rank_known_char` are the bit-identical counterparts of the JAX package's
narrow planes (one 8-byte row per block and character); nothing on the
card's path calls them.  `walk_runs` turns one block's emissions into a
sorted-unique (value, count) rank array on the device, with the root run
added.
"""

from __future__ import annotations

import torch

from ..kernels import WALK_EMIT, WALK_PLANES_BUILD
from .rank_torch import BLK, LANES, SENT, SIGMA, check_rec, unpack_symbols

NC = SIGMA - 1        # walked characters 1..SIGMA-1 (endmarker never walked)
WALK_BLOCK_EMITS = 1 << 28   # emission lanes per walk launch (~10 GB of walk,
                             # unique and sort temporaries)
WALK_MAX_LEN = 1 << 14       # longest read the walk takes (as the JAX path)
PLANE_WORDS = 7              # mask words per wide-plane row
SUPER = PLANE_WORDS * BLK    # positions per row: 224, one 32-byte sector


def _int32_wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def build_cplanes(rec: torch.Tensor) -> torch.Tensor:
    """Per-character (occ, bitmask) planes from the record table:
    int32[NBLK*NC, 2], row (block*NC + c-1) = [occ_c, mask_c] with bit k of
    mask_c set iff the block's position k holds c.  Bit-identical to
    walk_jax.build_cplanes (whose mask is the same uint32, bit-cast)."""
    nblk = rec.shape[0]
    syms = unpack_symbols(rec[:, LANES:])                       # [NBLK, 32]
    bit = torch.ones(BLK, dtype=torch.int64, device=rec.device) << torch.arange(
        BLK, device=rec.device)
    rows = []
    for c in range(1, SIGMA):
        mask = torch.where(syms == c, bit, 0).sum(dim=1)       # [NBLK]
        rows.append(torch.stack([rec[:, c], _int32_wrap(mask)], dim=1))
    return torch.stack(rows, dim=1).reshape(nblk * NC, 2).contiguous()


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (PyTorch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def rank_known_char(cpl: torch.Tensor, C: torch.Tensor, a: torch.Tensor,
                    cc: torch.Tensor) -> torch.Tensor:
    """LF(a, cc) = C[cc] + rank(a, cc) for known characters cc in [1, NC]:
    one narrow-plane row per lane.  int64[R]."""
    a = a.to(torch.int64)
    cc = cc.to(torch.int64)
    row = cpl[(a >> 5) * NC + (cc - 1)].to(torch.int64)        # [R, 2]
    mask = row[:, 1] & 0xFFFFFFFF                              # uint32 bits
    low = (torch.ones_like(a) << (a & (BLK - 1))) - 1          # no int32 wrap
    return C.to(torch.int64)[cc] + row[:, 0] + _popcount32(mask & low)


def n_super_blocks(nblk: int) -> int:
    return -(-nblk // PLANE_WORDS)


def build_walk_planes_plain(rec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the wide planes: int32[NSB, NC, 8] with
    NSB = ceil(NBLK / 7); row (sb, c-1) = [occ of c before position 224*sb,
    m_0 .. m_6], bit k of m_w set iff position 224*sb + 32*w + k holds c
    (zero past the record table)."""
    nblk = rec.shape[0]
    n_sb = n_super_blocks(nblk)
    narrow = build_cplanes(rec).view(nblk, NC, 2)
    masks = torch.zeros((n_sb * PLANE_WORDS, NC), dtype=torch.int32,
                        device=rec.device)
    masks[:nblk] = narrow[:, :, 1]
    planes = torch.empty((n_sb, NC, 1 + PLANE_WORDS), dtype=torch.int32,
                         device=rec.device)
    planes[:, :, 0] = narrow[::PLANE_WORDS, :, 0]
    planes[:, :, 1:] = masks.view(n_sb, PLANE_WORDS, NC).permute(0, 2, 1)
    return planes


def build_walk_planes(rec: torch.Tensor) -> torch.Tensor:
    """The walk's table from the record table: wide planes
    int32[NSB, NC, 8] (see build_walk_planes_plain).  CUDA tensors launch
    walk_planes_build of csrc/walk.cu; CPU tensors take the plain
    version."""
    check_rec(rec, "build_walk_planes")
    if rec.device.type == "cpu":
        return build_walk_planes_plain(rec)
    if rec.device.type != "cuda":
        raise ValueError(f"build_walk_planes: unsupported device {rec.device}")
    if not rec.is_contiguous() or rec.data_ptr() % 16:
        raise ValueError("build_walk_planes needs a contiguous, 16-byte "
                         "aligned rec")
    nblk = rec.shape[0]
    n_sb = n_super_blocks(nblk)
    planes = torch.empty((n_sb, NC, 1 + PLANE_WORDS), dtype=torch.int32,
                         device=rec.device)
    with torch.cuda.device(rec.device):
        WALK_PLANES_BUILD.launch(rec.data_ptr(), nblk, planes.data_ptr(),
                                 n_sb)
    return planes


def rank_wide(planes: torch.Tensor, C: torch.Tensor, a: torch.Tensor,
              cc: torch.Tensor) -> torch.Tensor:
    """LF(a, cc) = C[cc] + rank(a, cc) for known characters cc in [1, NC]
    over the wide planes: one 32-byte row per lane.  int64[R]."""
    a = a.to(torch.int64)
    cc = cc.to(torch.int64)
    sb = a // SUPER
    off = a - sb * SUPER
    row = planes[sb, cc - 1].to(torch.int64)                   # [R, 8]
    masks = row[:, 1:] & 0xFFFFFFFF                            # uint32 bits
    word = (off >> 5)[:, None]
    low = ((torch.ones_like(a) << (off & (BLK - 1))) - 1)[:, None]
    w = torch.arange(PLANE_WORDS, device=a.device)[None, :]
    take = torch.where(w < word, 0xFFFFFFFF, torch.where(w == word, low, 0))
    return (C.to(torch.int64)[cc] + row[:, 0]
            + _popcount32(masks & take).sum(dim=1))


def walk_emit_plain(planes: torch.Tensor, C: torch.Tensor,
                    creads: torch.Tensor, a_sequences: int):
    """Plain PyTorch version of the walk over the wide planes: (emits
    int32[max_len*R] with 2^31-1 in dead lanes, n_live int64 scalar
    tensor)."""
    max_len, r = creads.shape
    a = torch.full((r,), int(a_sequences), dtype=torch.int64,
                   device=creads.device)
    emits = torch.empty((max_len, r), dtype=torch.int32, device=creads.device)
    n_live = torch.zeros((), dtype=torch.int64, device=creads.device)
    for t in range(max_len):
        c = creads[t].to(torch.int64)
        alive = (c >= 1) & (c <= NC)
        child = rank_wide(planes, C, a, c.clamp(1, NC))
        a = torch.where(alive, child, a)
        emits[t] = torch.where(alive, child, SENT).to(torch.int32)
        n_live += alive.sum()
    return emits.reshape(-1), n_live


def walk_emit(planes: torch.Tensor, C: torch.Tensor, creads: torch.Tensor,
              a_sequences: int):
    """The walk over creads int8[max_len, R] (characters from each read's
    end, 0 past it) through the wide planes of build_walk_planes: (emits
    int32[max_len*R], n_live int64 scalar tensor).  CUDA tensors launch
    kernel K2; CPU tensors take walk_emit_plain."""
    if planes.dtype != torch.int32 or planes.dim() != 3 \
            or planes.shape[1:] != (NC, 1 + PLANE_WORDS):
        raise ValueError(f"planes must be int32[NSB, {NC}, "
                         f"{1 + PLANE_WORDS}], got "
                         f"{planes.dtype}{list(planes.shape)}")
    if C.dtype != torch.int32 or C.shape != (LANES + 1,):
        raise ValueError(f"C must be int32[{LANES + 1}]")
    if creads.dtype != torch.int8 or creads.dim() != 2:
        raise ValueError(f"creads must be int8[max_len, R], got "
                         f"{creads.dtype}{list(creads.shape)}")
    if not (planes.device == C.device == creads.device):
        raise ValueError("walk_emit: tensors on different devices")
    if not 0 <= a_sequences < min(SENT, planes.shape[0] * SUPER):
        raise ValueError(f"a_sequences {a_sequences} out of range")
    if planes.device.type == "cpu":
        return walk_emit_plain(planes, C, creads, a_sequences)
    if planes.device.type != "cuda":
        raise ValueError(f"walk_emit: unsupported device {planes.device}")
    if not (planes.is_contiguous() and C.is_contiguous()
            and creads.is_contiguous()):
        raise ValueError("walk_emit needs contiguous tensors")
    if planes.data_ptr() % 32:
        raise ValueError("walk_emit needs 32-byte aligned planes")
    max_len, r = creads.shape
    emits = torch.empty(max_len * r, dtype=torch.int32, device=planes.device)
    n_live = torch.zeros((), dtype=torch.int64, device=planes.device)
    if max_len and r:
        with torch.cuda.device(planes.device):
            WALK_EMIT.launch(planes.data_ptr(), C.data_ptr(),
                             creads.data_ptr(), max_len, r, int(a_sequences),
                             emits.data_ptr(), n_live.data_ptr())
    return emits, n_live


def walk_runs(planes: torch.Tensor, C: torch.Tensor, creads: torch.Tensor,
              a_sequences: int, root_count: int):
    """One read block's rank array on the device: sorted-unique
    (values int64[U], counts int64[U]).

    Dead lanes are dropped, duplicates summed, and the root run (value
    a_sequences, count root_count = the block's read count) added to the
    same multiset, so an emission equal to a_sequences (c = 1 at rank 0)
    gets the root count added rather than a second entry."""
    emits, _ = walk_emit(planes, C, creads, a_sequences)
    live = emits[emits != SENT].to(torch.int64)
    root = torch.tensor([a_sequences], dtype=torch.int64, device=live.device)
    values, inverse = torch.unique(torch.cat([live, root]), sorted=True,
                                   return_inverse=True)
    weights = torch.ones(live.shape[0] + 1, dtype=torch.int64,
                         device=live.device)
    weights[-1] = root_count
    counts = torch.zeros_like(values).index_add_(0, inverse, weights)
    return values, counts
