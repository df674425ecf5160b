"""Device-resident FM-index in PyTorch: batched rank / LF over a BWT.

Port of bwtmerge_tpu/ops/rank_jax.py.  The layout is the same block-fused
record table, bit for bit:

  rec: int32[NBLK, 16]   one 64-byte record per 32-position block
       rec[b, 0:8]  = occ counts of each char in positions [0, 32*b)
       rec[b, 8:16] = the block's 32 symbols, 4 packed per int32 (LSB first)

  rank(i, c) = rec[i >> 5, c] + #{positions p < (i & 31) of the block: sym == c}

with NBLK = size // 32 + 1 so that i == size resolves (its block's tail is
SIGMA-filled, and no query lane counts SIGMA).  The host packs the text to
0.5 B/position (native nib4_pack, as the JAX build does) and the record
table is derived on the device with plain torch ops.

The queries here are the gather path (one record row per query).  Large
sorted batches go through the hand-written streamed probe instead
(rank_streamed.py); batch_count switches at the same batch size as the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import resolve_device
from ..models.runs import RunArrays

SIGMA = 6
LANES = 8        # occ lanes (sigma padded)
BLK = 32         # positions per block
REC = 16         # int32 words per record: 8 occ + 8 packed-symbol words
NIB_FILL = SIGMA | (SIGMA << 4)  # pad byte: no query lane counts SIGMA
SENT = 2**31 - 1
STREAMED_MIN_BATCH = 1 << 14     # batch_count's switch to the streamed search


def c_array(counts) -> np.ndarray:
    """int32[LANES + 1] cumulative counts from per-character counts, padded
    with the total (rank_jax.DeviceFMIndex.build's C)."""
    counts = np.asarray(counts)
    c_arr = np.zeros(LANES + 1, dtype=np.int32)
    c_arr[: counts.size + 1] = np.concatenate(([0], np.cumsum(counts)))
    c_arr[counts.size + 1:] = c_arr[counts.size]
    return c_arr


def pack_nibbles_chunked(chunks):
    """Stream (syms, lens) run chunks into the block-planar nibble layout
    (byte k of block b: position 32b+k low, 32b+16+k high; SIGMA-filled
    tail) without materializing run arrays or decoded text: peak host
    memory is the 0.5 B/position buffer plus one decoded window.

    Port of rank_jax.pack_nibbles_chunked, unbucketed: the buffer is exactly
    (size // BLK + 1) * BLK / 2 bytes.  Returns (nibbles uint8, counts
    int64[SIGMA], size, n_runs), where n_runs counts the maximal runs of the
    text: equal neighbours merge inside a chunk as well as across chunk
    seams, and zero-length runs count nothing."""
    cap = 1 << 16                                    # positions
    nib = np.full(cap // 2, NIB_FILL, dtype=np.uint8)
    carry = np.zeros(0, np.uint8)
    pos = 0
    counts = np.zeros(SIGMA, np.int64)
    n_runs = 0
    last_sym = -1
    for syms, lens in chunks:
        syms = np.asarray(syms, np.uint8)
        lens = np.asarray(lens, np.int64)
        keep = lens > 0
        if not keep.all():
            syms, lens = syms[keep], lens[keep]
        if syms.size == 0:
            continue
        np.add.at(counts, syms, lens)
        n_runs += (syms.size - int(np.count_nonzero(syms[1:] == syms[:-1]))
                   - (1 if syms[0] == last_sym else 0))
        last_sym = int(syms[-1])
        # decode in bounded sub-windows (a chunk's decoded size is not
        # bounded by its encoded size for long runs)
        cum = np.concatenate(([0], np.cumsum(lens)))
        total_w = int(cum[-1])
        w = 0
        while w < total_w:
            end = min(w + (1 << 22), total_w)
            i0 = int(np.searchsorted(cum, w, side="right")) - 1
            i1 = int(np.searchsorted(cum, end, side="left"))
            wl = lens[i0:i1].copy()
            wl[0] -= w - cum[i0]
            wl[-1] -= cum[i1] - end
            win = np.repeat(syms[i0:i1], wl)
            if carry.size:
                win = np.concatenate([carry, win])
            usable = win.size // BLK * BLK
            if pos + usable + BLK > cap:
                cap = max(2 * cap, pos + usable + BLK)
                grown = np.full(cap // 2, NIB_FILL, np.uint8)
                grown[: nib.size] = nib
                nib = grown
            if usable:
                blk = win[:usable].reshape(-1, BLK)
                nib[pos // 2: (pos + usable) // 2] = (
                    blk[:, :16] | (blk[:, 16:] << 4)).reshape(-1)
                pos += usable
            carry = win[usable:]
            w = end
    size = pos + carry.size
    if carry.size:
        tail = np.full(BLK, SIGMA, np.uint8)
        tail[: carry.size] = carry
        nib[pos // 2: pos // 2 + BLK // 2] = tail[:16] | (tail[16:] << 4)
    need = (size // BLK + 1) * BLK // 2
    if nib.size < need:
        grown = np.full(need, NIB_FILL, np.uint8)
        grown[: nib.size] = nib
        nib = grown
    return nib[:need], counts, size, n_runs


def build_rec(nibbles: torch.Tensor, nblk: int) -> torch.Tensor:
    """Block-planar nibble text (uint8[>= nblk*16], byte k of block b holds
    position 32b+k in its low nibble and 32b+16+k in its high nibble) ->
    record table int32[nblk, REC], on the tensor's device.  Same values as
    rank_jax._build_rec_device."""
    nib2 = nibbles[: nblk * 16].view(nblk, 16)
    by_block = torch.cat([nib2 & 0xF, nib2 >> 4], dim=1)       # [nblk, 32]
    per_block = torch.stack(
        [(by_block == c).sum(dim=1, dtype=torch.int32) for c in range(LANES)],
        dim=1)                                                 # [nblk, LANES]
    occ = torch.cumsum(per_block, dim=0, dtype=torch.int32) - per_block
    b32 = by_block.to(torch.int32)
    packed = (b32[:, 0::4] | (b32[:, 1::4] << 8) | (b32[:, 2::4] << 16)
              | (b32[:, 3::4] << 24))
    return torch.cat([occ, packed], dim=1).contiguous()


def check_rec(rec: torch.Tensor, what: str) -> None:
    """Raise unless rec is a record table, int32[NBLK >= 1, REC]."""
    if rec.dtype != torch.int32 or rec.dim() != 2 or rec.shape[1] != REC \
            or rec.shape[0] < 1:
        raise ValueError(f"{what}: rec must be int32[NBLK, {REC}], got "
                         f"{rec.dtype}{list(rec.shape)}")


def unpack_symbols(words: torch.Tensor) -> torch.Tensor:
    """Packed symbol words int32[N, 8] -> int64[N, BLK] symbols in position
    order (word w holds positions 4w..4w+3, LSB first)."""
    w = words.to(torch.int64)
    return torch.stack([(w >> (8 * b)) & 0xFF for b in range(4)],
                       dim=2).reshape(-1, BLK)


def probe_rows(rec: torch.Tensor, i: torch.Tensor):
    """One record row per position i (int64, in [0, 32*NBLK)): (occ [Q, LANES]
    int32, syms [Q, BLK] int64, before [Q, BLK] mask of the block's
    positions < i, off [Q])."""
    row = rec[i >> 5]                                          # [Q, REC]
    off = i & (BLK - 1)
    before = torch.arange(BLK, device=rec.device)[None, :] < off[:, None]
    return row[:, :LANES], unpack_symbols(row[:, LANES:]), before, off


@dataclass(frozen=True)
class DeviceFMIndex:
    """Block-fused FM-index resident in device memory."""

    rec: torch.Tensor   # int32[NBLK, REC]
    C: torch.Tensor     # int32[LANES+1] cumulative char counts
    size: int           # total positions
    n_runs: int         # run count of the source RLE (informational)

    @property
    def device(self) -> torch.device:
        return self.rec.device

    @classmethod
    def from_nibbles(cls, nibbles: np.ndarray, counts, size: int,
                     n_runs: int = 0, device="cuda") -> "DeviceFMIndex":
        """Build from a block-planar nibble buffer already packed on the host
        (pack_nibbles_chunked): the k-way fold's piece upload, which never
        materializes run arrays.  Same record table as `build`."""
        dev = resolve_device(device)
        if size >= 2**31 - 1:
            raise ValueError(
                f"BWT shard of {size} positions exceeds int32 device layout")
        nblk = size // BLK + 1
        if nibbles.size < nblk * BLK // 2:
            raise ValueError(f"nibble buffer of {nibbles.size} bytes is short "
                             f"of {size} positions")
        rec = build_rec(torch.from_numpy(nibbles[: nblk * BLK // 2]).to(dev),
                        nblk)
        return cls(rec=rec, C=torch.from_numpy(c_array(counts)).to(dev),
                   size=size, n_runs=n_runs)

    @classmethod
    def build(cls, runs: RunArrays, counts=None,
              device="cuda") -> "DeviceFMIndex":
        """Pack the runs to nibbles on the host, upload 0.5 B/position and
        derive the record table on `device`."""
        from ..native import nib4_pack

        dev = resolve_device(device)
        size = runs.size()
        if size >= 2**31 - 1:
            # strictly below int32-max: the walk reserves 2^31-1 as its
            # dead-lane sentinel, so a rank equal to it must not exist
            raise ValueError(
                f"BWT shard of {size} positions exceeds int32 device layout")
        nblk = size // BLK + 1  # extra block so i == size resolves
        nibbles = np.full(nblk * BLK // 2, NIB_FILL, dtype=np.uint8)
        wrote = nib4_pack(runs.syms, runs.lens, nibbles)
        if wrote != size:
            raise ValueError(f"nib4_pack wrote {wrote} of {size} positions")
        counts = runs.counts(SIGMA) if counts is None else np.asarray(counts)
        rec = build_rec(torch.from_numpy(nibbles).to(dev), nblk)
        return cls(rec=rec, C=torch.from_numpy(c_array(counts)).to(dev),
                   size=size, n_runs=runs.n_runs)

    def _positions(self, i) -> torch.Tensor:
        return torch.as_tensor(i, device=self.device).to(torch.int64)

    def _probe(self, i):
        return probe_rows(self.rec, self._positions(i))

    @staticmethod
    def _count(syms, before, c) -> torch.Tensor:
        return ((syms == c[:, None]) & before).sum(dim=1, dtype=torch.int32)

    # -- core queries (all batched) -------------------------------------------

    def ranks_all(self, i) -> torch.Tensor:
        """rank(i, c) for every c: int32[Q, LANES].  i in [0, size]."""
        occ, syms, before, _ = self._probe(i)
        cols = [((syms == c) & before).sum(dim=1, dtype=torch.int32)
                for c in range(LANES)]
        return occ + torch.stack(cols, dim=1)

    def rank(self, i, c) -> torch.Tensor:
        """rank(i, c) per (i, c) pair: int32[Q]."""
        occ, syms, before, _ = self._probe(i)
        c = self._positions(c)
        return occ.gather(1, c[:, None])[:, 0] + self._count(syms, before, c)

    def inverse_select(self, i):
        """(rank(i, BWT[i]), BWT[i]) per position, both int32[Q]."""
        occ, syms, before, off = self._probe(i)
        sym = syms.gather(1, off[:, None])[:, 0]
        rnk = occ.gather(1, sym[:, None])[:, 0] + self._count(syms, before, sym)
        return rnk, sym.to(torch.int32)

    def access(self, i) -> torch.Tensor:
        _, syms, _, off = self._probe(i)
        return syms.gather(1, off[:, None])[:, 0].to(torch.int32)

    def LF_step(self, i):
        """(LF(i), BWT[i]) batched."""
        rnk, sym = self.inverse_select(i)
        return self.C[sym.to(torch.int64)] + rnk, sym


# -- backward search ----------------------------------------------------------


def backward_search(index: DeviceFMIndex, patterns: torch.Tensor,
                    lengths: torch.Tensor, max_len: int):
    """Batched backward search over the gather path: closed SA ranges
    (sp, ep) int32[Q] of each pattern; empty matches have ep < sp.

    patterns: int[Q, max_len] comp values, only the first lengths[q] read.
    Same contract as rank_jax.backward_search."""
    pat = patterns.to(torch.int64)
    lens = lengths.to(torch.int64)
    q = pat.shape[0]
    rows = torch.arange(q, device=pat.device)
    C = index.C.to(torch.int64)
    last = pat[rows, lens - 1]
    sp = C[last]
    ep = C[last + 1] - 1
    for t in range(max_len - 1):
        idx = lens - 2 - t
        active = (idx >= 0) & (ep >= sp)
        c = pat[rows, idx.clamp(0, max_len - 1)]
        new_sp = C[c] + index.rank(sp, c)
        new_ep = C[c] + index.rank(ep + 1, c) - 1
        sp = torch.where(active, new_sp, sp)
        ep = torch.where(active, new_ep, ep)
    return sp.to(torch.int32), ep.to(torch.int32)


def encode_patterns(patterns, char2comp: np.ndarray):
    """str/bytes/array patterns -> (int32[Q, max_len] comps, int32[Q]
    lengths).  ASCII str patterns take one vectorised pass."""
    if all(isinstance(p, str) for p in patterns):
        joined = "".join(patterns).encode()
        lens = np.fromiter((len(p) for p in patterns), np.int64,
                           count=len(patterns))
        if len(joined) == int(lens.sum()):        # one byte per character
            flat = char2comp[np.frombuffer(joined, dtype=np.uint8)]
            max_len = int(lens.max())
            out = np.zeros((len(patterns), max_len), np.int32)
            starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
            rows = np.repeat(np.arange(len(patterns)), lens)
            cols = np.arange(flat.size) - np.repeat(starts, lens)
            out[rows, cols] = flat
            return out, lens.astype(np.int32)
    comps = []
    for p in patterns:
        if isinstance(p, str):
            p = p.encode()
        if isinstance(p, (bytes, bytearray)):
            arr = char2comp[np.frombuffer(bytes(p), dtype=np.uint8)]
        else:
            arr = np.asarray(p)
        comps.append(arr.astype(np.int32))
    max_len = max(c.size for c in comps)
    out = np.zeros((len(comps), max_len), np.int32)
    for j, c in enumerate(comps):
        out[j, : c.size] = c
    return out, np.array([c.size for c in comps], np.int32)


def batch_count(index: DeviceFMIndex, patterns, char2comp: np.ndarray,
                chunk: int = 1 << 16) -> np.ndarray:
    """Occurrence counts (int64) for a list of str/bytes/array patterns.

    Same chunking, padding and batch-size switch as rank_jax.batch_count:
    chunks of up to `chunk` patterns, pad rows are 1-char dummies, and
    batches of 2^14 or more take the streamed search (the hand-written
    probe kernel on CUDA)."""
    if not patterns:
        return np.zeros(0, dtype=np.int64)
    return count_encoded(index, *encode_patterns(patterns, char2comp), chunk)


def count_encoded(index: DeviceFMIndex, comps: np.ndarray,
                  comp_lens: np.ndarray, chunk: int = 1 << 16) -> np.ndarray:
    """batch_count of patterns already encoded: comps int[Q, max_len] (comp
    values, the first comp_lens[q] of row q read), comp_lens int[Q]."""
    from .rank_streamed import backward_search_streamed

    comps = np.asarray(comps)
    comp_lens = np.asarray(comp_lens)
    q, max_len = comps.shape
    if q == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.empty(q, dtype=np.int64)
    q_pad = min(chunk, 1 << max(6, (q - 1).bit_length()))
    search = (backward_search_streamed if q_pad >= STREAMED_MIN_BATCH
              else backward_search)
    for start in range(0, q, q_pad):
        n = min(q_pad, q - start)
        pat = np.zeros((q_pad, max_len), dtype=np.int32)
        lens = np.ones(q_pad, dtype=np.int32)  # pad queries: 1-char dummies
        pat[:n] = comps[start:start + n]
        lens[:n] = np.maximum(comp_lens[start:start + n], 1)
        sp, ep = search(index, torch.from_numpy(pat).to(index.device),
                        torch.from_numpy(lens).to(index.device), max_len)
        got = (ep[:n].to(torch.int64) - sp[:n].to(torch.int64) + 1).cpu()
        out[start:start + n] = np.maximum(0, got.numpy())
    return out
