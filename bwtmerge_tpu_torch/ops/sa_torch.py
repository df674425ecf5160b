"""Multi-string BWT construction on a torch device: prefix-doubling suffix
array and RLO read ordering as `torch.sort` programs.

Port of bwtmerge_tpu/ops/sa_jax.py.  The same O(n log^2 n) algorithm as the
host oracle's numpy prefix doubling (models/oracle.py suffix_array), each
round one device sort.  The reference has no equivalent: it consumes BWTs
prebuilt by external tools (ropebwt / ropebwt2, paper.tex:274).

Collection conventions follow models/oracle.py build_bwt: sequence k is
terminated by a distinct endmarker $_k with $_i < $_j iff i < j, encoded by
remapping endmarker k -> value k and character c -> m + c.

Doubling terminates for reads at ~log2(max read length) rounds (the unique
endmarkers make distant positions distinct early), so the BWT of a 50 bp
read collection costs some 7 device sorts.  The loop's test is one host
read a round.

Every lane is int64, on purpose.  A round sorts ONE key,
`(rank << 32) | (second + 1)`: torch has no multi-operand sort, `second` is
-1 past the end of the text (the end-of-string rule: a suffix that runs off
the end sorts before every longer suffix sharing its prefix), and ranks
stay below 2^31, which the 2^31-1 position guards keep.  `torch.cumsum` of
the bool change marks gives int64 ranks directly.

What the JAX module does for the TPU and this one does not, because none of
it is part of the result:
- program-size buckets (`_bucket`) and the text padded up to them with
  distinct descending values (`_end_padding`): torch compiles no program
  per shape, and with no pad suffix `second = -1` alone is the
  end-of-string rule;
- the inverse permutation computed by a sort: a scatter `rank[order] = r`
  serves here;
- the nibble-packed upload and download and the sort that undoes the
  two-plane packing, made for a slow host link: the reads go up one byte a
  character and the BWT comes down one byte a symbol;
- the previous character carried as a sort payload in place of a gather:
  `bwt_of_pos[order]` is one gather.

One thing it does that the JAX module leaves to the host: the BWT is
run-length encoded on the device (interleave_torch.rle_runs_device), so
the run arrays come down and the host makes no pass over n positions
(that pass took 84% of a 102 M-position build; PERF.md).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..kernels import resolve_device
from ..models.runs import RunArrays
from .interleave_torch import rle_runs_device

MAX_POSITIONS = 2**31 - 1      # ranks must fit the key's 31-bit halves


def _ranks_of_sorted(keys_sorted: torch.Tensor) -> torch.Tensor:
    """int64 rank of every sorted key: the count of key changes before it."""
    changed = torch.zeros(keys_sorted.numel(), dtype=torch.bool,
                          device=keys_sorted.device)
    changed[1:] = keys_sorted[1:] != keys_sorted[:-1]
    return torch.cumsum(changed, dim=0)


def _sa_ranks(text: torch.Tensor, stats: Optional[dict] = None):
    """Prefix-doubling ranks over `text` (int64[n], n >= 1, on its device).

    Returns (order int64[n], rank int64[n]): `order` is the suffix array,
    `rank` its inverse.  A suffix that runs off the end of the text sorts
    before every longer suffix that shares its prefix.  `stats`, when
    given, receives the number of sorts under "rounds" and the seconds
    between the loop's host reads, one a sort, under "round_s".
    """
    n = text.numel()
    t_last = time.monotonic()
    round_s = []
    # round 0: rank by first character
    t_sorted, order = torch.sort(text)
    r_sorted = _ranks_of_sorted(t_sorted)
    del t_sorted
    rank = torch.empty(n, dtype=torch.int64, device=text.device)
    rank[order] = r_sorted
    rounds = 1
    k = 1
    # one host read a round: the last rank is n - 1 once all are distinct
    while int(r_sorted[-1]) != n - 1:
        round_s.append(time.monotonic() - t_last)
        t_last = time.monotonic()
        # second key: rank of the suffix k positions on, -1 past the end;
        # the + 1 keeps the low half of the packed key non-negative
        key = rank << 32
        if k < n:
            key[: n - k] |= rank[k:] + 1
        key_sorted, order = torch.sort(key)
        del key
        r_sorted = _ranks_of_sorted(key_sorted)
        del key_sorted
        rank[order] = r_sorted
        rounds += 1
        k *= 2
    round_s.append(time.monotonic() - t_last)
    if stats is not None:
        stats.update(rounds=rounds, round_s=round_s)
    return order, rank


def suffix_array_device(text: np.ndarray, device="cuda") -> np.ndarray:
    """Suffix array of an int array by prefix doubling on `device`.

    Matches models/oracle.suffix_array exactly (tests pin it)."""
    text = np.asarray(text)
    n = text.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n >= MAX_POSITIONS:
        raise ValueError(f"text of {n} positions exceeds the device suffix "
                         "sort's 31-bit ranks; shard the collection first")
    dev = resolve_device(device)
    order, _ = _sa_ranks(torch.from_numpy(text.astype(np.int64)).to(dev))
    return order.cpu().numpy()


def _bwt_of_collection(flat: torch.Tensor, lengths: torch.Tensor, n: int,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """BWT (uint8[n], one symbol a byte) of the collection whose characters
    (uint8[n - m], comp values >= 1) and read lengths (int64[m]) are on the
    device.  The oracle's remapped text (endmarker k -> k, char c -> m + c)
    is assembled here: an endmarker's ordinal is the count of endmarkers
    before it.  The BWT symbol of position 0, or of a position whose
    predecessor is an endmarker, is 0."""
    m = lengths.numel()
    device = flat.device
    is_end = torch.zeros(n, dtype=torch.bool, device=device)
    is_end[torch.cumsum(lengths + 1, dim=0) - 1] = True
    text = torch.empty(n, dtype=torch.int64, device=device)
    text[~is_end] = flat.to(torch.int64) + m
    text[is_end] = torch.arange(m, dtype=torch.int64, device=device)
    del is_end

    order, _ = _sa_ranks(text, stats)
    # previous character within the sequence: a predecessor that is an
    # endmarker (value < m), or none at position 0, gives the endmarker 0
    bwt_of_pos = torch.zeros(n, dtype=torch.uint8, device=device)
    prev = text[:-1]
    bwt_of_pos[1:] = torch.where(prev < m, 0, prev - m).to(torch.uint8)
    return bwt_of_pos[order]


def pack_collection(sequences):
    """(flat, lengths) packed form of a sequence collection: every host
    pass over it is then vectorized, with no Python loop over the reads."""
    if isinstance(sequences, tuple) and len(sequences) == 2:
        flat, lengths = sequences
        return (np.ascontiguousarray(flat, dtype=np.int32),
                np.asarray(lengths, dtype=np.int64))
    seqs = [np.asarray(s) for s in sequences]
    lengths = np.fromiter((s.size for s in seqs), dtype=np.int64,
                          count=len(seqs))
    flat = (np.concatenate(seqs).astype(np.int32) if seqs
            else np.zeros(0, np.int32))
    return flat, lengths


def _reorder_packed(flat: np.ndarray, lengths: np.ndarray,
                    order: np.ndarray):
    """Packed collection with its sequences permuted by `order` (one
    vectorized gather, no per-read Python)."""
    if lengths.size and (lengths == lengths[0]).all():
        # fixed-length fast path: one row gather, no index temporaries
        ln = int(lengths[0])
        return flat.reshape(-1, ln)[order].reshape(-1), lengths.copy()
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    new_lengths = lengths[order]
    total = int(lengths.sum())
    # source index of each output position: run k copies from
    # starts[order[k]] for new_lengths[k] positions
    out_starts = np.concatenate([[0], np.cumsum(new_lengths)[:-1]])
    pos = np.arange(total, dtype=np.int64)
    row = np.repeat(np.arange(order.size, dtype=np.int64), new_lengths)
    src = starts[order][row] + (pos - out_starts[row])
    return flat[src], new_lengths


def build_bwt_device(sequences, device="cuda",
                     stats: Optional[dict] = None) -> RunArrays:
    """Device analog of oracle.build_bwt: BWT of a sequence collection.

    Builds '<seq>$_k' concatenated with the oracle's remapping (endmarker
    k -> k, char c -> m + c) on the device, runs the device suffix sort, and
    gathers each suffix's previous character.  Output is identical to
    oracle.build_bwt (pinned by tests/test_torch_build.py).  `sequences` may
    be a list of arrays or a packed (flat, lengths) tuple.  `stats`, when
    given, receives positions, rounds and the seconds of the device part
    (upload to download, synchronised) and of the host run-length pass.
    """
    flat, lengths = pack_collection(sequences)
    m = lengths.size
    if flat.size and flat.min() <= 0:
        raise ValueError(
            "sequences must contain comp values >= 1 (no endmarkers)")
    n = int(lengths.sum()) + m
    if n >= MAX_POSITIONS:
        raise ValueError(f"collection of {n} positions exceeds the device "
                         "suffix sort's 31-bit ranks; shard the collection "
                         "first")
    if n == 0:
        return RunArrays.empty()
    dev = resolve_device(device)
    t0 = time.monotonic()
    syms, lens = rle_runs_device(_bwt_of_collection(
        torch.from_numpy(flat.astype(np.uint8)).to(dev),
        torch.from_numpy(lengths).to(dev), n, stats))
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.monotonic()
    runs = RunArrays(syms.cpu().numpy(), lens.cpu().numpy())
    if stats is not None:
        stats.update(positions=n, device_s=t1 - t0,
                     runs_s=time.monotonic() - t1)
    return runs


# -- RLO read ordering ---------------------------------------------------------

_RLO_BITS = 3          # comp values 0..5 fit in 3 bits
_RLO_PER_KEY = 30 // _RLO_BITS   # chars per int32 key of rlo_pack_keys (the
                                 # layout the JAX package sorts; sign bit
                                 # spare)


def _rlo_sort(keys: torch.Tensor) -> torch.Tensor:
    """Read order by the key columns of `keys` (int32[n_keys, m], most
    significant first), ties in input order: two 30-bit keys to an int64,
    then one stable sort per int64 key from the least significant up."""
    n_keys, m = keys.shape
    wide = keys.to(torch.int64)
    order = torch.arange(m, dtype=torch.int64, device=keys.device)
    for j in range((n_keys - 1) // 2 * 2, -1, -2):
        key = wide[j] << (_RLO_BITS * _RLO_PER_KEY)
        if j + 1 < n_keys:
            key = key | wide[j + 1]
        _, perm = torch.sort(key[order], stable=True)
        order = order[perm]
    return order


def rlo_pack_keys(flat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Fixed-width reverse-lexicographic sort keys for a packed read
    collection: int32[n_keys, m], 10 chars per key (3 bits/char), reversed
    reads zero-padded past the end (pad sorts below every character, so a
    read that is a suffix of a longer read sorts first).  Lexicographic
    order of the key columns == RLO order of the reads
    (models/build.rlo_order)."""
    m = lengths.size
    max_len = int(lengths.max()) if m else 0
    # vectorized reversed-read matrix: rev[i, j] = read i's char at
    # position len_i - 1 - j (0 past the end)
    if (lengths == max_len).all():
        rev = flat.reshape(m, max_len)[:, ::-1].astype(np.int32)
    else:
        rev = np.zeros((m, max_len), dtype=np.int32)
        total = int(lengths.sum())
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pos = np.arange(total, dtype=np.int64)
        row = np.repeat(np.arange(m, dtype=np.int64), lengths)
        off = pos - starts[row]                   # position within the read
        rev[row, lengths[row] - 1 - off] = flat
    n_keys = (max_len + _RLO_PER_KEY - 1) // _RLO_PER_KEY
    keys = np.zeros((n_keys, m), dtype=np.int32)
    for j in range(n_keys):
        block = rev[:, j * _RLO_PER_KEY: (j + 1) * _RLO_PER_KEY]
        acc = np.zeros(m, dtype=np.int32)
        for col in range(block.shape[1]):
            acc = (acc << _RLO_BITS) | block[:, col]
        # left-align the final (possibly short) block so shorter pads
        # compare below longer content, matching per-column lexsort
        acc <<= _RLO_BITS * (_RLO_PER_KEY - block.shape[1])
        keys[j] = acc
    return keys


def rlo_order_device(sequences, device="cuda") -> np.ndarray:
    """Device analog of models/build.rlo_order: permutation sorting reads
    into reverse-lexicographic order.

    Packs the reversed reads into fixed-width keys (rlo_pack_keys) on the
    host, then stable device sorts order the collection.  Identical to the
    numpy lexsort path (pinned by tests).  `sequences` may be a list of
    arrays or a packed (flat, lengths) tuple."""
    flat, lengths = pack_collection(sequences)
    m = lengths.size
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    if int(lengths.max()) == 0:
        return np.arange(m, dtype=np.int64)
    dev = resolve_device(device)
    keys = rlo_pack_keys(flat, lengths)
    return _rlo_sort(torch.from_numpy(keys).to(dev)).cpu().numpy()
