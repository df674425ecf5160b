"""The table builders' bit arithmetic, rehearsed on the CPU.

csrc/rec_build.cu (rec_build) and the table builders of csrc/walk.cu
(walk_planes_build) and csrc/decode.cu (decode_rows_build) run only on a
card, and no compiler here can check them.  Their arithmetic is
transcribed step for step in numpy uint32 (the bit planes, the AND
combinations, the word-pair fold and the multiply that gathers a bit plane
in position order (csrc/symbol_plane.cuh), the byte permutes, the
two-lanes-a-word scans, the decoupled look-back, the staging swizzle and
the decode rows' assembly) and held against the plain versions:
rank_torch.block_counts and build_rec_plain,
walk_torch.build_walk_planes_plain, decode_torch.build_decode_rows_plain,
and the JAX package's mask shifts (walk_jax._SHIFTS) and record table
(rank_jax._build_rec_device).  kernels._stale, which decides what `nvcc`
rebuilds, is tested here too.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwtmerge_tpu.ops.rank_jax import _build_rec_device
from bwtmerge_tpu.ops.walk_jax import _SHIFTS
from bwtmerge_tpu_torch import kernels
from bwtmerge_tpu_torch.ops.decode_torch import (ROW_WORDS,
                                                 build_decode_rows_plain)
from bwtmerge_tpu_torch.ops.rank_torch import (BLK, LANES, NIB_FILL, REC,
                                               REC_THREADS, REC_TILE,
                                               block_counts, build_rec_plain)
from bwtmerge_tpu_torch.ops.walk_torch import (NC, PLANE_WORDS,
                                               build_walk_planes_plain)

U32 = np.uint32
PER = REC_TILE // REC_THREADS         # record blocks a thread
WARPS = REC_THREADS // 32
CHUNK_SHIFT = 4                       # log2 of the chunks a thread stages
AGGREGATE, INCLUSIVE = 1, 2           # look-back status flags


def u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64).astype(U32)


def popc(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(U32)


def sel(m, a, b):
    return (a & U32(m)) | (b & ~U32(m))


# ---- rec_build --------------------------------------------------------------

def nibble_plane(v: np.ndarray, t: int) -> np.ndarray:
    """rec_build.cu plane<T>: v uint32[..., 4] nibble words."""
    x = v[..., 0] >> U32(t)
    y = v[..., 1] >> U32(t - 1) if t >= 1 else v[..., 1] << U32(1)
    z = v[..., 2] >> U32(t - 2) if t >= 2 else v[..., 2] << U32(2 - t)
    w = v[..., 3] << U32(3 - t)
    return sel(0x77777777, sel(0x33333333, sel(0x11111111, x, y), z), w)


def packed_counts(v: np.ndarray) -> np.ndarray:
    """rec_build.cu block_counts: uint32[..., 4], lanes 2k | 2k+1 << 16."""
    p0, p1, p2, p3 = (nibble_plane(v, t) for t in range(4))
    lo, hi = ~p2 & ~p3, p2 & ~p3
    n = [popc(~p0 & ~p1 & lo), popc(p0 & ~p1 & lo), popc(~p0 & p1 & lo),
         popc(p0 & p1 & lo), popc(~p0 & ~p1 & hi), popc(p0 & ~p1 & hi),
         popc(~p0 & p1 & hi), popc(p0 & p1 & hi)]
    return np.stack([n[2 * k] | (n[2 * k + 1] << U32(16))
                     for k in range(LANES // 2)], axis=-1)


def unpack(pk: np.ndarray) -> np.ndarray:
    out = np.empty(pk.shape[:-1] + (LANES,), U32)
    out[..., 0::2] = pk & U32(0xFFFF)
    out[..., 1::2] = pk >> U32(16)
    return out


def warp_inclusive_scan(x: np.ndarray) -> np.ndarray:
    """The kernel's shuffle scan over axis -2 (32 lanes): at step s a lane
    adds the value of lane - s, for lanes >= s."""
    x = x.copy()
    for s in (1, 2, 4, 8, 16):
        up = np.zeros_like(x)
        up[..., s:, :] = x[..., :-s, :]
        x = x + up
    return x


def swz(n):
    return n ^ ((n >> CHUNK_SHIFT) & 7)


def look_back(status, tile: int, base: np.ndarray) -> np.ndarray:
    """rec_build.cu look_back's sum for `tile`: warp 0's 32 lanes, lane
    c + 8d reading lane c of tile - 1 - d - 4j, a group's lanes summing the
    values before and at the nearest inclusive prefix.  status[t] is
    (flags int[8], values uint32[8]), one flag a lane."""
    excl = np.zeros(LANES, U32)
    done = np.zeros(LANES, bool)
    t0 = tile - 1
    while True:
        flags = np.empty((4, LANES), int)
        vals = np.empty((4, LANES), U32)
        for d in range(4):
            t = t0 - d
            if t >= 0:
                flags[d], vals[d] = status[t][0], status[t][1]
            else:
                flags[d], vals[d] = INCLUSIVE, base
        inclusive = flags == INCLUSIVE
        before = np.zeros((4, LANES), bool)
        for d in range(4):
            for k in range(1, 4):
                if d >= k:
                    before[d] |= inclusive[d - k]
        add = np.where(~done[None, :] & ~before, vals, U32(0)).sum(
            axis=0, dtype=np.uint64).astype(U32)
        excl = excl + add
        done |= inclusive.any(axis=0)
        if done.all():
            return excl
        t0 -= 4


def rec_build_transcribed(nib: np.ndarray, nblk: int, base, rng) -> np.ndarray:
    """The whole of rec_build_kernel over every tile in numpy.  Tiles run
    in index order; each finds its predecessors' status words, lane by
    lane, published as aggregates or inclusive prefixes at random (tile 0
    always inclusive), as a look-back may find them."""
    base = u32(np.asarray(base, np.int64) & 0xFFFFFFFF)
    ntiles = -(-nblk // REC_TILE)
    v = np.full((ntiles * REC_TILE, 4), 0xFFFFFFFF, U32)
    v[:nblk] = nib[: nblk * 16].view("<u4").reshape(nblk, 4)
    pk = packed_counts(v).reshape(ntiles, REC_THREADS, PER, 4)
    run = np.cumsum(pk, axis=2, dtype=U32)
    pre = run - pk                                          # before a block
    total = run[:, :, -1, :].reshape(ntiles, WARPS, 32, 4)
    inc = warp_inclusive_scan(total)
    assert int(unpack(inc).max()) <= 32 * 32 * PER          # fits 16 bits
    warp_pk = inc[:, :, 31, :]                              # [T, WARPS, 4]
    warp_ex = np.cumsum(warp_pk, axis=1, dtype=U32) - warp_pk
    agg = unpack(warp_pk).sum(axis=1, dtype=np.uint64).astype(U32)
    assert int(agg.max()) <= 32 * REC_TILE <= 0xFFFF
    incls, out = [], np.empty((ntiles * REC_TILE * 4, 4), U32)
    m = U32(0x0F0F0F0F)
    for tile in range(ntiles):
        if tile == 0:
            excl = base
        else:
            view = []
            for t in range(tile):
                flags = (np.full(LANES, INCLUSIVE) if t == 0 else
                         rng.integers(AGGREGATE, INCLUSIVE + 1, size=LANES))
                view.append((flags, np.where(flags == INCLUSIVE, incls[t],
                                             agg[t])))
            excl = look_back(view, tile, base)
        incls.append(excl + agg[tile])
        ex = (inc[tile] - total[tile]).reshape(REC_THREADS, 4) \
            + np.repeat(warp_ex[tile], 32, axis=0)
        occ = excl + unpack(ex[:, None, :] + pre[tile])     # [THREADS, PER, 8]
        words = v[tile * REC_TILE:(tile + 1) * REC_TILE].reshape(
            REC_THREADS, PER, 4)
        stage = np.zeros((REC_TILE * 4, 4), U32)
        n = (np.arange(REC_THREADS)[:, None] * PER + np.arange(PER)) * 4
        stage[swz(n)] = occ[..., :4]
        stage[swz(n + 1)] = occ[..., 4:]
        stage[swz(n + 2)] = words & m
        stage[swz(n + 3)] = (words >> U32(4)) & m
        j = np.arange(REC_TILE * 4)
        out[tile * REC_TILE * 4 + j] = stage[swz(j)]
    return out[: nblk * 4].reshape(nblk, REC).view(np.int32)


def _nibbles(syms: np.ndarray) -> np.ndarray:
    blocks = syms.reshape(-1, BLK).astype(np.uint8)
    return (blocks[:, :16] | (blocks[:, 16:] << 4)).reshape(-1)


def _every_value_at_every_position(rng) -> np.ndarray:
    """16 x 32 blocks: block 32v + p holds nibble value v at position p and
    random symbols 0..15 elsewhere."""
    syms = rng.integers(0, 16, size=(16, BLK, BLK))
    for val in range(16):
        syms[val, np.arange(BLK), np.arange(BLK)] = val
    return syms.reshape(-1)


def _cases():
    rng = np.random.default_rng(11)
    return {
        "every value at every position": _every_value_at_every_position(rng),
        "random 0..15": rng.integers(0, 16, size=300 * BLK),
        "random 0..6": rng.integers(0, 7, size=300 * BLK),
        "pad bytes": np.full(5 * BLK, NIB_FILL & 0xF),
        "past the table": np.full(3 * BLK, 15),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_bit_plane_counts_match_block_counts(case):
    syms = _cases()[case]
    nib = _nibbles(syms)
    nblk = nib.size // 16
    v = nib.view("<u4").reshape(nblk, 4)
    got = unpack(packed_counts(v)).astype(np.int32)
    want = block_counts(torch.from_numpy(nib), nblk).numpy()
    np.testing.assert_array_equal(got, want)
    # the bit planes hold each nibble's bits, in the order counting needs
    for t in range(4):
        p = nibble_plane(v, t)
        for i in range(8):
            for j in range(4):
                np.testing.assert_array_equal(
                    (p >> U32(4 * i + j)) & U32(1),
                    (v[:, j] >> U32(4 * i + t)) & U32(1))


@pytest.mark.parametrize("nblk,symbols", [
    (1, 7), (REC_TILE - 1, 7), (REC_TILE, 7), (REC_TILE + 1, 7),
    (2 * REC_TILE + 1, 7), (9 * REC_TILE + 5, 16), (3 * REC_TILE, 1)])
def test_rec_build_transcribed_matches_plain(nblk, symbols):
    rng = np.random.default_rng(nblk)
    syms = rng.integers(0, symbols, size=nblk * BLK)
    syms[nblk * BLK - 1 - nblk % BLK:] = NIB_FILL & 0xF
    nib = _nibbles(syms)
    for base in (np.zeros(LANES, np.int64),
                 rng.integers(-2**31, 2**31, size=LANES)):
        want = build_rec_plain(torch.from_numpy(nib), nblk,
                               torch.from_numpy(base.astype(np.int32)))
        got = rec_build_transcribed(nib, nblk, base, rng)
        np.testing.assert_array_equal(got, want.numpy())


def test_look_back_meets_the_nearest_inclusive_prefix():
    # every lane its own scan: lanes stop at different tiles, and a tile
    # past the first four inclusive-free ones takes a second window
    rng = np.random.default_rng(3)
    base = u32(rng.integers(0, 2**32, size=LANES))
    for trial in range(200):
        n = int(rng.integers(1, 14))
        aggs = u32(rng.integers(0, 2**32, size=(n, LANES)))
        incl = base + np.cumsum(aggs, axis=0, dtype=U32)
        status = []
        for t in range(n):
            # each lane's word is published on its own: one tile's lanes
            # may show an aggregate and an inclusive prefix side by side
            flags = (np.full(LANES, INCLUSIVE) if t == 0 else
                     rng.integers(AGGREGATE, INCLUSIVE + 1, size=LANES))
            status.append((flags, np.where(flags == INCLUSIVE, incl[t],
                                           aggs[t])))
        want = base + np.sum(aggs, axis=0, dtype=U32)
        np.testing.assert_array_equal(look_back(status, n, base), want)


def test_staging_swizzle_is_a_conflict_free_permutation():
    n = np.arange(REC_TILE * 4)
    assert np.array_equal(np.sort(swz(n)), n)
    # eight threads storing the same chunk of their records, and eight
    # threads reading neighbouring chunks, hit eight 16-byte bank columns
    for i in range(4 * PER):
        for t0 in range(0, REC_THREADS, 8):
            cols = swz((np.arange(t0, t0 + 8) << CHUNK_SHIFT) + i) & 7
            assert len(set(cols.tolist())) == 8
    for j0 in range(0, REC_TILE * 4, 8):
        assert len(set((swz(np.arange(j0, j0 + 8)) & 7).tolist())) == 8


# ---- walk_planes_build ------------------------------------------------------

def byte_perm(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """CUDA's __byte_perm with selectors 0..7."""
    src = [(x >> U32(8 * b)) & U32(0xFF) for b in range(4)] \
        + [(y >> U32(8 * b)) & U32(0xFF) for b in range(4)]
    return sum((src[(s >> (4 * n)) & 7] << U32(8 * n)) for n in range(4)
               ).astype(U32)


def fold_symbol_words(words: np.ndarray) -> np.ndarray:
    """symbol_plane.cuh fold_symbol_words: words uint32[..., 8] packed
    symbols -> uint32[..., 4], q[p] = word 2p | word 2p+1 << 4, written as
    a multiply-add (symbol bytes are 0..15, so the halves never overlap)."""
    return words[..., 0::2] + words[..., 1::2] * U32(16)


def symbol_plane(q: np.ndarray, k: int) -> np.ndarray:
    """symbol_plane.cuh symbol_plane<K>: q uint32[..., 4] folded word
    pairs."""
    t = [(q[..., p] & U32(0x11111111 << k)) * U32(0x01020408 >> k)
         for p in range(4)]
    return byte_perm(byte_perm(t[0], t[1], 0x0073),
                     byte_perm(t[2], t[3], 0x0073), 0x5410)


def test_symbol_plane_multiply_needs_no_shift():
    # (q & (m << k)) * (M >> k) is ((q >> k) & m) * M modulo 2^32: the
    # header's form saves a shift a word pair
    q = u32(np.random.default_rng(2).integers(0, 2**32, size=4096))
    for k in range(4):
        np.testing.assert_array_equal(
            (q & U32(0x11111111 << k)) * U32(0x01020408 >> k),
            ((q >> U32(k)) & U32(0x11111111)) * U32(0x01020408))


def block_masks(words: np.ndarray) -> np.ndarray:
    """walk.cu's masks of characters 1..5: words uint32[N, 8] packed
    symbols -> uint32[N, NC]."""
    q = fold_symbol_words(words)
    p0, p1, p2, p3 = (symbol_plane(q, k) for k in range(4))
    lo, hi = ~p2 & ~p3, p2 & ~p3
    return np.stack([p0 & ~p1 & lo, ~p0 & p1 & lo, p0 & p1 & lo,
                     ~p0 & ~p1 & hi, p0 & ~p1 & hi], axis=1)


def walk_planes_transcribed(rec: np.ndarray) -> np.ndarray:
    """walk_planes_build_kernel: slot 0 the occ of block 7*sb, slots 1..7
    the masks of blocks 7*sb .. 7*sb+6 (zero past the table)."""
    nblk = rec.shape[0]
    n_sb = -(-nblk // PLANE_WORDS)
    masks = np.zeros((n_sb * PLANE_WORDS, NC), U32)
    masks[:nblk] = block_masks(rec[:, LANES:].view(U32))
    planes = np.empty((n_sb, NC, 1 + PLANE_WORDS), U32)
    planes[:, :, 0] = rec[::PLANE_WORDS, 1:1 + NC].view(U32)
    planes[:, :, 1:] = masks.reshape(n_sb, PLANE_WORDS, NC).transpose(0, 2, 1)
    return planes.view(np.int32)


def _records(syms: np.ndarray, rng) -> np.ndarray:
    """A record table with random occ lanes and the given symbols 0..15
    packed as the record table holds them."""
    blocks = syms.reshape(-1, BLK).astype(np.uint32)
    rec = np.empty((blocks.shape[0], REC), np.int32)
    rec[:, :LANES] = rng.integers(-2**31, 2**31, size=(blocks.shape[0],
                                                       LANES))
    words = (blocks[:, 0::4] | (blocks[:, 1::4] << 8) | (blocks[:, 2::4] << 16)
             | (blocks[:, 3::4] << 24))
    rec[:, LANES:] = words.view(np.int32)
    return rec


@pytest.mark.parametrize("case", list(_cases()))
def test_swar_masks_match_the_jax_shifts(case):
    syms = _cases()[case]
    rec = _records(syms, np.random.default_rng(5))
    got = block_masks(rec[:, LANES:].view(U32))
    by_lane = np.concatenate(
        [(rec[:, LANES:].view(U32) >> U32(8 * b)) & U32(0xFF)
         for b in range(4)], axis=1)                 # walk_jax's lane order
    for c in range(1, NC + 1):
        want = np.where(by_lane == c, _SHIFTS[None, :], U32(0)).sum(
            axis=1, dtype=np.uint64).astype(U32)
        np.testing.assert_array_equal(got[:, c - 1], want)


@pytest.mark.parametrize("nblk", [1, 2, 3, 4, 5, 6, 7, 8, 13, 14, 15, 700])
def test_walk_planes_transcribed_matches_plain(nblk):
    rng = np.random.default_rng(nblk)
    syms = rng.integers(0, 8, size=nblk * BLK)      # symbols 6 and 7 too
    rec = _records(syms, rng)
    want = build_walk_planes_plain(torch.from_numpy(rec)).numpy()
    np.testing.assert_array_equal(walk_planes_transcribed(rec), want)


# ---- decode_rows_build ------------------------------------------------------

def decode_row(records: np.ndarray) -> np.ndarray:
    """decode.cu decode_row: records uint32[N, 16] -> rows uint32[N, 8]."""
    q = fold_symbol_words(records[:, LANES:])
    planes = [symbol_plane(q, k) for k in range(ROW_WORDS - NC)]
    return np.concatenate([records[:, 1:1 + NC], np.stack(planes, axis=1)],
                          axis=1)


def decode_rows_transcribed(rec: np.ndarray) -> np.ndarray:
    """decode_rows_build_kernel: thread b of the grid builds block b's row
    from its record alone."""
    return decode_row(rec.view(U32)).view(np.int32)


@pytest.mark.parametrize("nblk", [1, 2, 3, 31, 32, 33, 255, 256, 257, 1023,
                                  1025, 5000])
def test_decode_rows_transcribed_matches_plain(nblk):
    # around a warp's and a thread block's blocks (one a thread); symbols
    # 0..6 in every table
    rng = np.random.default_rng(nblk)
    syms = rng.integers(0, 7, size=nblk * BLK)
    syms[:7] = np.arange(7)
    rec = _records(syms, rng)
    want = build_decode_rows_plain(torch.from_numpy(rec)).numpy()
    np.testing.assert_array_equal(decode_rows_transcribed(rec), want)


@pytest.mark.parametrize("symbols", [7, 16])
def test_decode_rows_every_symbol_at_every_position(symbols):
    # each value at each of a block's 32 positions, the rest random: the
    # fold's halves and the gathered bits land where the plain version has
    # them for every nibble, not only the symbols 0..6 a BWT holds
    rng = np.random.default_rng(symbols)
    syms = rng.integers(0, symbols, size=(symbols, BLK, BLK))
    for val in range(symbols):
        syms[val, np.arange(BLK), np.arange(BLK)] = val
    rec = _records(syms.reshape(-1), rng)
    want = build_decode_rows_plain(torch.from_numpy(rec)).numpy()
    np.testing.assert_array_equal(decode_rows_transcribed(rec), want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_decode_rows_of_the_jax_record_table(seed):
    # the JAX package's own record table of seeded nibbles (symbols 0..6):
    # the rows' occ words are its occ lanes 1..5, and bit j of plane k is
    # bit k of the symbol at position j, read from the nibbles themselves
    rng = np.random.default_rng(seed)
    nblk = int(rng.integers(1, 3000))
    syms = rng.integers(0, 7, size=(nblk, BLK)).astype(np.uint8)
    nib = (syms[:, :16] | (syms[:, 16:] << 4)).reshape(-1)
    rec = np.asarray(_build_rec_device(jnp.asarray(nib)))
    rows = decode_rows_transcribed(rec).view(U32)
    np.testing.assert_array_equal(rows[:, :NC], rec[:, 1:1 + NC].view(U32))
    for k in range(ROW_WORDS - NC):
        bits = (rows[:, NC + k, None] >> np.arange(BLK, dtype=U32)) & U32(1)
        np.testing.assert_array_equal(bits, (syms >> k) & 1)


# ---- kernels._stale ---------------------------------------------------------

def test_a_newer_header_makes_every_library_stale(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    for name in ("a.cu", "b.cu", "shared.cuh", "notes.txt"):
        (csrc / name).write_text("//\n")
    for name in ("a.cu", "b.cu", "shared.cuh", "notes.txt"):
        os.utime(csrc / name, (1000, 1000))
    assert kernels._stale("a.cu")                     # no library yet
    for src in ("a.cu", "b.cu"):
        lib = kernels._lib_path(src)
        open(lib, "w").close()
        os.utime(lib, (2000, 2000))
    assert not kernels._stale("a.cu") and not kernels._stale("b.cu")
    os.utime(csrc / "notes.txt", (3000, 3000))        # not a header
    assert not kernels._stale("a.cu")
    os.utime(csrc / "shared.cuh", (3000, 3000))
    assert kernels._stale("a.cu") and kernels._stale("b.cu")
    os.utime(kernels._lib_path("a.cu"), (4000, 4000))
    assert not kernels._stale("a.cu") and kernels._stale("b.cu")
    os.utime(csrc / "a.cu", (5000, 5000))             # its own source
    assert kernels._stale("a.cu")
