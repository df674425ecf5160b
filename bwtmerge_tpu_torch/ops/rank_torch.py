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
table is derived on the device in one piece by the hand-written rec_build
(csrc/rec_build.cu; build_rec_plain is its plain version), whose peak
memory is the nibbles and the table: the JAX package's slabs are not
needed.

The queries here are the gather path (one record row per query).  Large
sorted batches go through the hand-written streamed probe instead
(rank_streamed.py); batch_count switches at the same batch size as the JAX
package, but searches the whole batch at once where the JAX package cuts
it into fixed chunks of one program shape: only a batch whose working set
passes COUNT_BUDGET is cut, into as few chunks as the budget allows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import REC_BUILD, resolve_device
from ..models.runs import RunArrays

SIGMA = 6
LANES = 8        # occ lanes (sigma padded)
BLK = 32         # positions per block
REC = 16         # int32 words per record: 8 occ + 8 packed-symbol words
NIB_FILL = SIGMA | (SIGMA << 4)  # pad byte: no query lane counts SIGMA
SENT = 2**31 - 1
MAX_SIZE = SENT - 1   # the largest index the layout takes: SENT is no rank
STREAMED_MIN_BATCH = 1 << 14     # batch_count's switch to the streamed search
# Device working set of one chunk of a count (batch_count, count_encoded):
# a row takes COUNT_ROW_BYTES in a search step (its two range ends, their
# sort, K1's 64-byte output column each) and COUNT_CHAR_BYTES a character
# (its int32 comp and map_comps' transients): 1,024 B a row of 32, where
# an H100 measured 533.5 B a row plus 17 MB fixed at 2^21 rows of 32
# (chip_smoke.counts_by_chunk).  4 GiB holds the paper's
# 2^21 32-mers in one chunk with room to spare; a batch of long rows is cut.
COUNT_BUDGET = 1 << 32
COUNT_ROW_BYTES = 512
COUNT_CHAR_BYTES = 16
REC_TILE = 1024  # record blocks a tile of csrc/rec_build.cu (its kTile)
REC_THREADS = 256    # threads a tile (its kThreads): 4 blocks a thread
REC_STATUS_WORDS = 16   # int32 words of look-back status a tile


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


def _by_block(nibbles: torch.Tensor, nblk: int) -> torch.Tensor:
    nib2 = nibbles[: nblk * 16].view(nblk, 16)
    return torch.cat([nib2 & 0xF, nib2 >> 4], dim=1)          # [nblk, 32]


def block_counts(nibbles: torch.Tensor, nblk: int) -> torch.Tensor:
    """int32[nblk, LANES]: each block's count of each symbol value, from
    block-planar nibbles (see build_rec_plain)."""
    by_block = _by_block(nibbles, nblk)
    return torch.stack(
        [(by_block == c).sum(dim=1, dtype=torch.int32) for c in range(LANES)],
        dim=1)


def pack_symbol_words(nibbles: torch.Tensor, nblk: int) -> torch.Tensor:
    """int32[nblk, 8]: each block's 32 symbols, word w holding positions
    4w..4w+3 one byte each, least significant first."""
    b32 = _by_block(nibbles, nblk).to(torch.int32)
    return (b32[:, 0::4] | (b32[:, 1::4] << 8) | (b32[:, 2::4] << 16)
            | (b32[:, 3::4] << 24))


def build_rec_plain(nibbles: torch.Tensor, nblk: int,
                    base=None) -> torch.Tensor:
    """Plain PyTorch version of the record build: block-planar nibble text
    (uint8[>= nblk*16], byte k of block b holds position 32b+k in its low
    nibble and 32b+16+k in its high nibble) -> record table int32[nblk,
    REC], on the tensor's device, its occ lanes raised by `base` (LANES
    counts; None is zero).  Same values as rank_jax._build_rec_device, and
    with a base as rank_jax._build_rec_slab's table."""
    per_block = block_counts(nibbles, nblk)
    occ = torch.cumsum(per_block, dim=0, dtype=torch.int32) - per_block
    if base is not None:
        occ += _base_row(base, nibbles.device)[None, :]
    return torch.cat([occ, pack_symbol_words(nibbles, nblk)],
                     dim=1).contiguous()


def _base_row(base, device) -> torch.Tensor:
    row = torch.as_tensor(base).to(device=device, dtype=torch.int32)
    if row.shape != (LANES,):
        raise ValueError(f"build_rec: base must hold {LANES} counts, got "
                         f"shape {list(row.shape)}")
    return row.contiguous()


def _check_nibbles(nibbles: torch.Tensor, nblk: int) -> None:
    if nibbles.dtype != torch.uint8 or nibbles.dim() != 1:
        raise ValueError(f"build_rec: nibbles must be uint8[N], got "
                         f"{nibbles.dtype}{list(nibbles.shape)}")
    if nblk < 1 or nibbles.numel() < nblk * 16:
        raise ValueError(f"build_rec: {nibbles.numel()} nibble bytes for "
                         f"{nblk} blocks (needs {nblk} >= 1 and "
                         f"{nblk * 16} bytes)")


def build_rec(nibbles: torch.Tensor, nblk: int, base=None) -> torch.Tensor:
    """The record table int32[nblk, REC] of block-planar nibble text, its
    occ lanes raised by `base` (see build_rec_plain).  CUDA tensors launch
    rec_build; CPU tensors take the plain version."""
    _check_nibbles(nibbles, nblk)
    if nibbles.device.type == "cpu":
        return build_rec_plain(nibbles, nblk, base)
    return rec_build(nibbles, nblk, base)


def rec_build(nibbles: torch.Tensor, nblk: int, base=None) -> torch.Tensor:
    """The kernel's entry: rec_build of csrc/rec_build.cu on the nibbles'
    CUDA device (contiguous, 16-byte aligned); raises for any other
    tensor.  Allocates the table and the kernel's look-back status (64 B
    a tile and the tile counter), which the launch zeroes."""
    _check_nibbles(nibbles, nblk)
    if nibbles.device.type != "cuda":
        raise ValueError(f"rec_build: needs a CUDA tensor, got one on "
                         f"{nibbles.device}")
    if not nibbles.is_contiguous() or nibbles.data_ptr() % 16:
        raise ValueError("rec_build needs contiguous, 16-byte aligned "
                         "nibbles")
    base_row = None if base is None else _base_row(base, nibbles.device)
    tiles = torch.empty(-(-nblk // REC_TILE) * REC_STATUS_WORDS + 2,
                        dtype=torch.int32, device=nibbles.device)
    rec = torch.empty((nblk, REC), dtype=torch.int32, device=nibbles.device)
    with torch.cuda.device(nibbles.device):
        REC_BUILD.launch(nibbles.data_ptr(), nblk,
                         None if base_row is None else base_row.data_ptr(),
                         tiles.data_ptr(), tiles.numel(), rec.data_ptr())
    return rec


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
        if size > MAX_SIZE:
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
        if size > MAX_SIZE:
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
        c = patterns[rows, idx.clamp(0, max_len - 1)].to(torch.int64)
        new_sp = C[c] + index.rank(sp, c)
        new_ep = C[c] + index.rank(ep + 1, c) - 1
        sp = torch.where(active, new_sp, sp)
        ep = torch.where(active, new_ep, ep)
    return sp.to(torch.int32), ep.to(torch.int32)


def pattern_bytes(patterns):
    """str/bytes/array patterns -> (uint8[Q, max_len] bytes, int32[Q]
    lengths, bool[Q] of the rows given as arrays of comp values, or None
    when there are none).  Row q holds pattern q's bytes (a str UTF-8
    encoded) and zeros past its length.  ASCII str patterns are joined and
    encoded in one pass; the other forms go through a loop."""
    q = len(patterns)
    given = None
    joined = None
    if all(isinstance(p, str) for p in patterns):
        joined = "".join(patterns).encode()
        lens = np.fromiter(map(len, patterns), np.int64, count=q)
        if len(joined) != int(lens.sum()):        # not one byte a character
            joined = None
    if joined is None:
        parts = []
        given = np.zeros(q, bool)
        for j, p in enumerate(patterns):
            if isinstance(p, str):
                p = p.encode()
            if not isinstance(p, (bytes, bytearray)):
                arr = np.asarray(p)
                if arr.size and (arr.min() < 0 or arr.max() > 255):
                    raise ValueError(f"pattern {j}: comp values outside "
                                     f"[0, 256)")
                p = arr.astype(np.uint8).tobytes()
                given[j] = True
            parts.append(bytes(p))
        joined = b"".join(parts)
        lens = np.fromiter(map(len, parts), np.int64, count=q)
        if not given.any():
            given = None
    flat = np.frombuffer(joined, np.uint8)
    max_len = int(lens.max()) if q else 0
    if q and int(lens.min()) == max_len:
        raw = flat.reshape(q, max_len).copy()
    else:
        raw = np.zeros((q, max_len), np.uint8)
        raw[np.arange(max_len)[None, :] < lens[:, None]] = flat
    return raw, lens.astype(np.int32), given


class PatternBatch:
    """A list of -v patterns as one byte matrix (pattern_bytes), shared by
    every count of a run: built at the first count that needs it, so that
    count's time holds it, and copied once to each device asked for.  Each
    count maps the bytes through its own index's char2comp (map_comps)."""

    def __init__(self, patterns):
        self.patterns = patterns
        self._bytes = None
        self._on = {}

    def __len__(self) -> int:
        return len(self.patterns)

    def on(self, device):
        """(raw, lens, given) of pattern_bytes as tensors on `device`,
        copied there once."""
        dev = torch.device(device)
        got = self._on.get(dev)
        if got is None:
            if self._bytes is None:
                self._bytes = pattern_bytes(self.patterns)
            got = tuple(None if a is None else torch.from_numpy(a).to(dev)
                        for a in self._bytes)
            self._on[dev] = got
        return got


def map_comps(raw: torch.Tensor, lens: torch.Tensor, given, table):
    """int32 comps of byte rows: each byte through `table` (char2comp, 256
    entries, int32), the rows marked in `given` (comp values) as they are,
    and 0 past each row's length."""
    comps = table[raw.to(torch.int32)]
    keep = torch.arange(raw.shape[1], device=raw.device)[None, :] \
        >= lens[:, None]
    if given is not None:
        keep |= given[:, None]
    return torch.where(keep, raw, comps).to(torch.int32)


def encode_patterns(patterns, char2comp: np.ndarray):
    """str/bytes/array patterns -> (int32[Q, max_len] comps, int32[Q]
    lengths) on the host: a str or bytes pattern's bytes through char2comp,
    an array's comp values as they are, zeros past each length."""
    raw, lens, given = pattern_bytes(patterns)
    comps = map_comps(torch.from_numpy(raw), torch.from_numpy(lens),
                      None if given is None else torch.from_numpy(given),
                      torch.from_numpy(np.asarray(char2comp, np.int32)))
    return comps.numpy(), lens


def batch_count(index: DeviceFMIndex, patterns, char2comp: np.ndarray,
                budget: int = COUNT_BUDGET) -> np.ndarray:
    """Occurrence counts (int64) for a list of str/bytes/array patterns, or
    a PatternBatch of them (whose byte matrix later counts reuse).

    Counts equal rank_jax.batch_count's, and batches of more than 2^13
    patterns take the streamed search as there (the hand-written probe
    kernel on CUDA).  The batch is searched whole, with no pad rows, unless
    its working set passes `budget` bytes (_count_rows).  The bytes are
    mapped through char2comp on the index's device, chunk by chunk."""
    if not len(patterns):
        return np.zeros(0, dtype=np.int64)
    if not isinstance(patterns, PatternBatch):
        patterns = PatternBatch(patterns)
    raw, lens, given = patterns.on(index.device)
    table = torch.from_numpy(np.asarray(char2comp, np.int32)).to(index.device)
    return _count_rows(index, lens, raw.shape[1], budget, lambda s, e: (
        map_comps(raw[s:e], lens[s:e], None if given is None else given[s:e],
                  table)))


def count_encoded(index: DeviceFMIndex, comps: np.ndarray,
                  comp_lens: np.ndarray,
                  budget: int = COUNT_BUDGET) -> np.ndarray:
    """batch_count of patterns already encoded: comps int[Q, max_len] (comp
    values, the first comp_lens[q] of row q read), comp_lens int[Q]."""
    comps = torch.as_tensor(np.asarray(comps)).to(index.device)
    lens = torch.as_tensor(np.asarray(comp_lens)).to(index.device)
    if comps.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    return _count_rows(index, lens, comps.shape[1], budget,
                       lambda s, e: comps[s:e])


def count_chunk_rows(max_len: int, budget: int = COUNT_BUDGET) -> int:
    """Rows of one chunk of a count at max_len characters a row: as many
    as `budget` bytes of device working set hold, and at least one."""
    return max(1, budget // (COUNT_ROW_BYTES + COUNT_CHAR_BYTES * max_len))


def _count_rows(index: DeviceFMIndex, lens: torch.Tensor, max_len: int,
                budget: int, rows) -> np.ndarray:
    """Counts of Q patterns whose comp rows rows(start, end) gives on the
    index's device: chunks of count_chunk_rows(max_len, budget) rows, each
    one search of max_len - 1 steps; the counts stay on the device until
    one copy.  The streamed search takes batches of more than
    STREAMED_MIN_BATCH / 2 patterns: those whose next power of two is at
    least STREAMED_MIN_BATCH, as in rank_jax.batch_count."""
    from .rank_streamed import backward_search_streamed

    q = lens.shape[0]
    search = (backward_search_streamed if q > STREAMED_MIN_BATCH // 2
              else backward_search)
    step = count_chunk_rows(max_len, budget)
    out = torch.empty(q, dtype=torch.int64, device=index.device)
    for start in range(0, q, step):
        end = min(q, start + step)
        sp, ep = search(index, rows(start, end),
                        lens[start:end].clamp(min=1), max_len)
        out[start:end] = (ep.to(torch.int64) - sp.to(torch.int64)
                          + 1).clamp(min=0)
    return out.cpu().numpy()
