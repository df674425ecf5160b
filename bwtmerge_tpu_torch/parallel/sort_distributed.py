"""Mesh-distributed sort and the sharded suffix-array construction.

Port of bwtmerge_tpu/parallel/sort_distributed.py.  An array is held as
equal shards, shard d on mesh entry d (parallel/mesh.py; entries may repeat
a device).  `sharded_sort` sorts it globally by Batcher's odd-even merge
network over sorted blocks: every comparator is a merge-split of two
shards (the high shard copied to the low shard's device, the two sorted
together there, the high half copied back), so by the 0-1 principle the
block sequence ends sorted.  `sharded_sample_sort` does it in O(1) bulk
exchanges: regular samples give P-1 splitters, the all_to_all of the JAX
package becomes a transposition of per-shard piece lists, and a rebalance
cuts the buckets back into equal shards.  The JAX package checks that
sort's static capacities on the device and falls back to the network on
overflow; here pieces have their true lengths, so there is no capacity and
no fallback.

torch has no multi-key sort.  A sort by several keys is one stable sort a
key, from the least significant up (_lexsort), and the doubling rounds
pack their two keys into one int64 as ops/sa_torch.py does,
`(rank << 32) | (second + 1)`, under its 2^31-1 position guard.  Ties of
all keys come out in an order of their own, unlike XLA's unstable sorts:
the results that count (suffix array, BWT, RLO order) are unique.

On that network `suffix_array_sharded` runs the prefix-doubling rounds of
ops/sa_torch.py with every step sharded: the doubling sort, the cross-shard
segment-rank scan (a cumsum a shard plus the totals of the shards before
it), the inversion (a sort by position) and the shift of the ranks by k
positions (copies from the next one or two shards).  Per-device memory is
O(n / P).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.runs import RunArrays
from ..ops.sa_torch import MAX_POSITIONS, pack_collection, rlo_pack_keys
from .mesh import mesh_devices

Shard = Tuple[torch.Tensor, ...]      # one shard of every operand


def _oddeven_rounds(p: int):
    """Batcher odd-even mergesort comparator rounds for p blocks.

    Returns a list of rounds; each round is a list of disjoint (low, high)
    comparator pairs that can exchange in parallel.  All comparators are
    ascending (min to the lower index), so blocks stay ascending-sorted
    throughout: no descending phases to track (unlike plain bitonic).
    """
    rounds = []
    length = 1
    while length < p:
        k = length
        while k >= 1:
            pairs = []
            for j in range(k % length, p - k, 2 * k):
                for i in range(min(k, p - j - k)):
                    if (i + j) // (2 * length) == (i + j + k) // (2 * length):
                        pairs.append((i + j, i + j + k))
            if pairs:
                rounds.append(pairs)
            k //= 2
        length *= 2
    return rounds


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by keys[0], then keys[1], ...: one stable sort a
    key from the last.  Equal rows keep their order."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for key in reversed(keys):
        _, perm = torch.sort(key[order].to(torch.int64), stable=True)
        order = order[perm]
    return order


def _local_sort(ops: Shard, num_keys: int) -> Shard:
    perm = _lexsort(ops[:num_keys])
    return tuple(x[perm] for x in ops)


def _split(operands, devices) -> List[Shard]:
    """Equal shards of the operands (arrays or tensors), shard d on
    devices[d]."""
    p = len(devices)
    ops = [torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor)
           else x for x in operands]
    n = ops[0].numel()
    if n % p:
        raise ValueError(f"size {n} not divisible by mesh size {p}")
    s = n // p
    return [tuple(x[d * s:(d + 1) * s].to(dev) for x in ops)
            for d, dev in enumerate(devices)]


def _join(shards: List[Shard]) -> Tuple[np.ndarray, ...]:
    return tuple(torch.cat([sh[j].cpu() for sh in shards]).numpy()
                 for j in range(len(shards[0])))


def _network_sort(shards: List[Shard], num_keys: int) -> List[Shard]:
    """Local sorts, then the odd-even merge network over the shards."""
    shards = [_local_sort(sh, num_keys) for sh in shards]
    s = shards[0][0].numel()
    for pairs in _oddeven_rounds(len(shards)):
        for lo, hi in pairs:
            dev_lo, dev_hi = shards[lo][0].device, shards[hi][0].device
            # low block first: the concatenation the JAX comparator sorts
            merged = _local_sort(tuple(
                torch.cat([a, b.to(dev_lo)])
                for a, b in zip(shards[lo], shards[hi])), num_keys)
            shards[lo] = tuple(m[:s] for m in merged)
            shards[hi] = tuple(m[s:].to(dev_hi) for m in merged)
    return shards


def _lex_lt(splitter_keys, elem_keys) -> torch.Tensor:
    """splitter < elem, lexicographic over the key tuples (broadcast)."""
    res = None
    for sk, ek in zip(reversed(splitter_keys), reversed(elem_keys)):
        lt, eq = sk < ek, sk == ek
        res = lt if res is None else lt | (eq & res)
    return res


def _sample_sort(shards: List[Shard], num_keys: int,
                 oversample: int = 64) -> List[Shard]:
    """Local sorts, splitters from regular samples, one exchange of the
    buckets (a transposition of the per-shard piece lists), local sorts of
    what each shard received, and a rebalance into equal shards."""
    p = len(shards)
    s = shards[0][0].numel()
    shards = [_local_sort(sh, num_keys) for sh in shards]
    r = min(oversample, s)
    samp_idx = torch.as_tensor((np.arange(r, dtype=np.int64) * s) // r)
    samples = [torch.cat([sh[j][samp_idx.to(sh[j].device)].cpu()
                          for sh in shards]).to(torch.int64)
               for j in range(num_keys)]
    perm = _lexsort(samples)
    spl_idx = torch.arange(1, p) * r
    splitters = [smp[perm][spl_idx] for smp in samples]

    # bucket = number of splitters strictly below the element: monotone
    # over a sorted shard, so each bucket is one contiguous slice (ties with
    # a splitter fall to the lower bucket)
    pieces: List[List[Shard]] = [[] for _ in range(p)]      # [dst][src]
    for sh in shards:
        dev = sh[0].device
        lt = _lex_lt(tuple(x.to(dev)[:, None] for x in splitters),
                     tuple(k.to(torch.int64)[None, :]
                           for k in sh[:num_keys]))           # [P-1, s]
        ends = torch.cumsum(torch.bincount(lt.sum(dim=0), minlength=p),
                            0).tolist()
        start = 0
        for dst in range(p):
            pieces[dst].append(tuple(x[start:ends[dst]] for x in sh))
            start = ends[dst]
    buckets = []
    for dst in range(p):
        dev = shards[dst][0].device
        buckets.append(_local_sort(tuple(
            torch.cat([pc[j].to(dev) for pc in pieces[dst]])
            for j in range(len(shards[0]))), num_keys))
    # rebalance: the buckets in order are the sorted array; cut it into p
    # shards of s, each on its own entry
    out = []
    offsets = np.cumsum([0] + [b[0].numel() for b in buckets])
    for d in range(p):
        lo, hi = d * s, (d + 1) * s
        dev = shards[d][0].device
        parts = []
        for q, b in enumerate(buckets):
            a, e = max(lo, offsets[q]), min(hi, offsets[q + 1])
            if e > a:
                parts.append(tuple(x[a - offsets[q]:e - offsets[q]].to(dev)
                                   for x in b))
        out.append(tuple(torch.cat([pt[j] for pt in parts])
                         for j in range(len(shards[0]))))
    return out


def sharded_sort(operands: Sequence, num_keys: int, mesh=None
                 ) -> Tuple[np.ndarray, ...]:
    """Globally sort equal-sharded [n] arrays lexicographically by the first
    `num_keys` operands, by the odd-even merge network over the mesh.  n
    must be divisible by the mesh size.  Returns the sorted operands as
    host arrays.  Ties are broken by the network; include a unique key (the
    position) for a total order that does not depend on it."""
    shards = _split(operands, mesh_devices(mesh))
    return _join(_network_sort(shards, num_keys))


def sharded_sample_sort(operands: Sequence, num_keys: int, mesh=None,
                        oversample: int = 64) -> Tuple[np.ndarray, ...]:
    """sharded_sort by splitter-based sample sort: one bulk exchange and a
    rebalance in place of the network's O(log^2 P) rounds, the trade at
    large P.  Same contract as sharded_sort.  Shards too small to sample
    (p == 1 or under 2p elements) take sharded_sort."""
    devices = mesh_devices(mesh)
    shards = _split(operands, devices)
    p, s = len(devices), shards[0][0].numel()
    if p == 1 or s < 2 * p:
        return _join(_network_sort(shards, num_keys))
    return _join(_sample_sort(shards, num_keys, oversample))


# -- sharded prefix doubling ---------------------------------------------------


def _seg_ranks(keys: List[torch.Tensor]) -> List[torch.Tensor]:
    """Global 0-based segment ranks of a globally SORTED sharded key: rank
    of an element = number of distinct keys strictly before it.  A cumsum
    of change flags a shard, plus the totals of the shards before it (the
    sharded analog of the rank scan of ops/sa_torch._ranks_of_sorted)."""
    out = []
    before = 0
    prev = None
    for k in keys:
        changed = torch.zeros(k.numel(), dtype=torch.bool, device=k.device)
        changed[1:] = k[1:] != k[:-1]
        if prev is not None:
            changed[0] = k[0] != prev.to(k.device)
        local = torch.cumsum(changed, dim=0)
        out.append(local + before)
        before += int(local[-1])
        prev = k[-1]
    return out


def _shift_left(ranks: List[torch.Tensor], k: int) -> List[torch.Tensor]:
    """rank[i + k] for every global position i, -1 past the end: shard d
    reads shards d + k // s and the one after it."""
    p = len(ranks)
    s = ranks[0].numel()
    hop, off = divmod(k, s)
    out = []
    for d, x in enumerate(ranks):
        src = [ranks[q].to(x.device) if q < p else torch.full_like(x, -1)
               for q in (d + hop, d + hop + 1)]
        out.append(torch.cat(src)[off:off + s])
    return out


def suffix_array_sharded(text, mesh=None,
                         sort_method: str = "oddeven") -> np.ndarray:
    """Suffix array by prefix doubling with every step sharded over the mesh.

    Matches models/oracle.suffix_array.  The text is padded to a multiple
    of the mesh size with distinct descending values below its minimum
    (the end-of-string convention of ops/sa_jax._end_padding), so pad
    suffixes take the first rows and the real suffix array is the tail.
    sort_method: 'oddeven' (sharded_sort's network) or 'sample'
    (sharded_sample_sort's exchange) for every sort of every round; the
    result is the same.
    """
    if sort_method not in ("oddeven", "sample"):
        raise ValueError(f"unknown sort_method {sort_method!r}")
    devices = mesh_devices(mesh)
    p = len(devices)
    text = np.asarray(text)
    n = text.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n >= MAX_POSITIONS:
        raise ValueError(f"text of {n} positions exceeds the suffix sort's "
                         "31-bit ranks; shard the collection first")
    n_pad = -(-n // p) * p
    lo = int(text.min())
    text_pad = np.concatenate([text.astype(np.int64),
                               np.arange(lo - 1, lo - 1 - (n_pad - n), -1,
                                         dtype=np.int64)])
    s = n_pad // p
    use_sample = sort_method == "sample" and p > 1 and s >= 2 * p

    def sort(shards, num_keys):
        if use_sample:
            return _sample_sort(shards, num_keys)
        return _network_sort(shards, num_keys)

    def ranked(key_shards, pos_shards):
        """Sort (key, position) pairs; rank the sorted keys; give the ranks
        back in position order.  (rank by position, sorted positions,
        last rank)."""
        srt = sort([(k, i) for k, i in zip(key_shards, pos_shards)], 2)
        r_sorted = _seg_ranks([sh[0] for sh in srt])
        inv = sort([(sh[1], r) for sh, r in zip(srt, r_sorted)], 1)
        return ([sh[1] for sh in inv], [sh[1] for sh in srt],
                int(r_sorted[-1][-1]))

    shards = _split((text_pad, np.arange(n_pad, dtype=np.int64)), devices)
    pos = [sh[1] for sh in shards]
    rank, order, last = ranked([sh[0] for sh in shards], pos)
    k = 1
    while last != n_pad - 1:
        # second key: rank k positions on, -1 past the end; + 1 keeps the
        # low half of the packed key non-negative
        second = _shift_left(rank, k)
        keys = [(r << 32) | (sec + 1) for r, sec in zip(rank, second)]
        rank, order, last = ranked(keys, pos)
        k *= 2
        if k > 2 * n_pad:   # safety: must have converged by then
            raise RuntimeError("sharded prefix doubling failed to converge")
    sa = torch.cat([o.cpu() for o in order]).numpy()
    return sa[n_pad - n:].astype(np.int64)


def rlo_order_sharded(sequences, mesh=None,
                      sort_method: str = "oddeven") -> np.ndarray:
    """Mesh-sharded analog of ops/sa_torch.rlo_order_device: the permutation
    sorting reads into reverse-lexicographic order.  The reversed reads pack
    into int32 keys (sa_torch.rlo_pack_keys, 3 bits a character, INT32_MAX
    a safe above-everything sentinel); the key columns and the read index,
    the last key (RLO keeps equal reads in input order), sort over the
    mesh.  Reads pad to a mesh multiple with sentinel keys that sort last.
    Identical to models/build.rlo_order."""
    devices = mesh_devices(mesh)
    p = len(devices)
    flat, lengths = pack_collection(sequences)
    m = lengths.size
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    if int(lengths.max()) == 0:
        return np.arange(m, dtype=np.int64)
    keys = rlo_pack_keys(flat, lengths)
    m_pad = -(-m // p) * p
    if m_pad > m:
        keys = np.pad(keys, ((0, 0), (0, m_pad - m)),
                      constant_values=np.int32(2**31 - 1))
    idx = np.arange(m_pad, dtype=np.int64)
    sort = sharded_sample_sort if sort_method == "sample" else sharded_sort
    out = sort(tuple(keys) + (idx,), num_keys=keys.shape[0] + 1, mesh=devices)
    return out[-1][:m].astype(np.int64)


def build_bwt_sharded(sequences, mesh=None,
                      sort_method: str = "oddeven") -> RunArrays:
    """Mesh-sharded analog of ops/sa_torch.build_bwt_device: the BWT of a
    collection whose suffix sort exceeds one device's memory, identical to
    oracle.build_bwt.  `sequences` may be a list of arrays or a packed
    (flat, lengths) tuple; sort_method as in suffix_array_sharded."""
    flat, lengths = pack_collection(sequences)
    m = lengths.size
    if flat.size and flat.min() <= 0:
        raise ValueError(
            "sequences must contain comp values >= 1 (no endmarkers)")
    n = int(lengths.sum()) + m
    if n == 0:
        return RunArrays.empty()
    text = np.empty(n, dtype=np.int64)
    ends = np.cumsum(lengths + 1) - 1
    mask = np.ones(n, dtype=bool)
    mask[ends] = False
    text[ends] = np.arange(m, dtype=np.int64)
    text[mask] = flat + m
    sa = suffix_array_sharded(text, mesh=mesh, sort_method=sort_method)
    prev = np.concatenate([[0], text[:-1]])[sa]
    bwt = np.where(prev < m, 0, prev - m).astype(np.uint8)
    return RunArrays.from_values(bwt)
