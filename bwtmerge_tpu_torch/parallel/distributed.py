"""Multi-process execution: torch.distributed bring-up, the rank-range
exchange of the rank array, and the sharded merge output.

Port of bwtmerge_tpu/parallel/distributed.py.  The reference is explicitly
single-node (paper.tex:197); this module scales the merge out with the same
decomposition the mesh uses across devices:

  processes -> a torch.distributed world (initialize_multihost)
  search    -> B's sequence blocks, one per process, then one per entry of
               the process's own mesh (parallel/mesh.py), each process
               holding whole indexes
  combine   -> A-POSITION-RANGE exchange: sample-based splitters partition
               [0, |A|] into one contiguous range per process; each process
               routes its sorted rank-array pieces to the owning process with
               one all_to_all and k-way merges the P pieces it receives.
               Per-process peak is O(|RA|/P + skew), never the whole rank
               array: the distributed analog of the RankArray k-way disk
               merge (support.h:576-638), with processes for temp files.
  merge     -> each process interleaves ITS OWN A-range against the shared
               inputs (the stateful native kernel started at the range's
               cursors) and encodes its fragment of the output file; process
               0 writes the headers and concatenates the fragments.

Every payload is a host array, so the collectives are gloo collectives on
CPU int64 tensors, on any machine (the JAX package ships them over a
one-device-per-process mesh, as int32 word pairs since its x64 is off;
neither is needed here).  A single-process call degrades to the local mesh
path, so the module is safe to use unconditionally.  The host half (the
interleave of one range, the coalescing of run chunks across range seams)
also serves the range-parallel host interleave (models/parallel_merge.py).
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         timeout_s: float = 300.0) -> None:
    """Form the torch.distributed world (gloo) of a multi-process merge: a
    no-op for a world of one.  `init_method` is the rendezvous address
    (tcp://host:port, which every process is given); a world that does not
    form within timeout_s raises."""
    import torch.distributed as dist

    if world_size is None or world_size <= 1:
        return
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a world."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_i64(x) -> np.ndarray:
    """All-gather an int64 vector of the same size on every process:
    int64[world, x.size]."""
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _local_rank_array(a_idx, b_idx, a_sequences: int, b_sequences: int,
                      mesh=None):
    """This process's sorted-unique rank-array runs for its own block of
    B's sequences, searched over its mesh (default: the device a_idx is on)
    by parallel/mesh.sharded_rank_array."""
    from .mesh import sequence_shards, sharded_rank_array

    pid, nproc = process_info()
    my_block = sequence_shards(b_sequences, nproc)[pid]
    sp, ep = int(my_block[0]), int(my_block[1])
    if ep < sp:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), False
    return sharded_rank_array(a_idx, b_idx, a_sequences, ep - sp + 1,
                              mesh=mesh or [a_idx.device], b_seq_offset=sp)


def exchange_by_rank_range(values: np.ndarray, counts: np.ndarray,
                           oversample: int = 64,
                           stats: Optional[dict] = None):
    """Route sorted-unique (values, counts) rank-array runs to their owning
    process by A-position range; return this process's merged range.

    Every process contributes `oversample` samples of its values at
    count-mass quantiles, with the mass each stands for; the sorted global
    sample's mass quantiles become the P-1 range splitters (process p owns
    [splitter[p-1], splitter[p]), ends open), so ranges balance the
    interleave's work (positions, not runs) even where a few runs carry
    huge counts.  One all_to_all (uneven splits) moves each piece to its
    owner; the P received pieces k-way merge through the native pairwise
    tournament.

    Returns (my_values, my_counts, b_offset), b_offset = the counts owned by
    lower ranges (the B-rank of this range's first insertion).  `stats`,
    when given, receives exchange_width (the largest piece), recv_runs and
    sent_runs.
    """
    import torch
    import torch.distributed as dist

    from ..models.spill import _merge_sorted_parts

    pid, nproc = process_info()
    values = np.ascontiguousarray(values, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if nproc == 1:
        if stats is not None:
            stats.update(exchange_width=0, recv_runs=values.size,
                         sent_runs=values.size)
        return values, counts, 0

    # --- splitters from count-mass-weighted samples ------------------------
    r = oversample
    if values.size:
        cm = np.cumsum(counts, dtype=np.int64)
        targets = (np.arange(r, dtype=np.int64) * cm[-1]) // r
        idx = np.minimum(np.searchsorted(cm, targets, side="right"),
                         values.size - 1)
        samp = values[idx]
        wts = np.full(r, max(int(cm[-1]) // r, 1), np.int64)
    else:
        samp = np.full(r, np.int64(2**62))  # empty: never attracts a range
        wts = np.zeros(r, np.int64)
    allp = _allgather_i64(np.concatenate([samp, wts]))
    all_samp = allp[:, :r].reshape(-1)
    all_wts = allp[:, r:].reshape(-1)
    order = np.argsort(all_samp, kind="stable")
    all_samp = all_samp[order]
    cw = np.cumsum(all_wts[order], dtype=np.int64)
    total_w = max(int(cw[-1]), 1)
    qmass = (np.arange(1, nproc, dtype=np.int64) * total_w) // nproc
    splitters = all_samp[np.minimum(
        np.searchsorted(cw, qmass, side="right"), all_samp.size - 1)]

    # --- bucket the local runs by owner -------------------------------------
    cuts = np.concatenate(([0], np.searchsorted(values, splitters),
                           [values.size]))
    piece_runs = np.diff(cuts).astype(np.int64)                     # [P]
    piece_count_sums = np.asarray(
        [counts[cuts[q]:cuts[q + 1]].sum() for q in range(nproc)],
        dtype=np.int64)
    sizes = _allgather_i64(piece_runs)                              # [P, P]
    count_sums = _allgather_i64(piece_count_sums)                   # [P, P]
    if stats is not None:
        stats.update(exchange_width=max(int(sizes.max()), 1),
                     recv_runs=int(sizes[:, pid].sum()),
                     sent_runs=int(values.size))

    # --- one all_to_all: piece q of every process to process q --------------
    recv_sizes = [int(n) for n in sizes[:, pid]]
    send = torch.from_numpy(np.stack([values, counts], axis=1))     # [n, 2]
    recv = torch.empty((sum(recv_sizes), 2), dtype=torch.int64)
    dist.all_to_all_single(recv, send, output_split_sizes=recv_sizes,
                           input_split_sizes=[int(n) for n in piece_runs])
    recv = recv.numpy()

    # --- merge the P received pieces ----------------------------------------
    parts = []
    start = 0
    for n in recv_sizes:
        if n:
            parts.append((np.ascontiguousarray(recv[start:start + n, 0]),
                          np.ascontiguousarray(recv[start:start + n, 1])))
        start += n
    if parts:
        my_values, my_counts = _merge_sorted_parts(parts)
        my_values = np.ascontiguousarray(my_values)
        my_counts = np.ascontiguousarray(my_counts)
    else:
        my_values = np.zeros(0, np.int64)
        my_counts = np.zeros(0, np.int64)
    b_offset = int(count_sums[:, :pid].sum())
    return my_values, my_counts, b_offset


def multihost_rank_array_ranged(a_idx, b_idx, a_sequences: int,
                                b_sequences: int, mesh=None,
                                stats: Optional[dict] = None):
    """Search and rank-range exchange: THIS process's range of the global
    rank array.

    Returns (values, counts, b_offset, lo, hi, drain, overflow):
      values/counts - sorted-unique runs owned by this process
      b_offset      - total counts in lower ranges (B-rank of the range
                      start)
      lo, hi        - this process's half-open A-position range; the ranges
                      TILE [0, inf): lo_0 = 0, lo_{p+1} = hi_p, so the
                      per-range interleaves concatenate to the full output
      drain         - True on exactly one process (the last NON-EMPTY
                      range): its fragment appends A's tail after its runs
      overflow      - always False (the JAX function's flag for a device
                      search that overflowed its static buffers)
    `mesh` is this process's own mesh (default: a_idx's device).  `stats`,
    when given, receives the exchange's figures and the seconds of the
    search (search_s) and of the exchange (exchange_s).
    """
    pid, nproc = process_info()
    t0 = time.monotonic()
    values, counts, _ = _local_rank_array(a_idx, b_idx, a_sequences,
                                          b_sequences, mesh)
    t1 = time.monotonic()
    if stats is not None:
        stats["search_s"] = t1 - t0
    if nproc == 1:
        if stats is not None:
            stats.update(exchange_width=0, recv_runs=values.size,
                         sent_runs=values.size)
        return values, counts, 0, 0, np.int64(2**62), True, False

    # the tiling range boundaries come from the merged ranges' FIRST values
    # (a tiny all-gather): the boundary between p and p+1 is p+1's first
    # value, so p's fragment advances A exactly to where p+1's begins.
    # Empty ranges collapse to lo == hi (their A span is covered by the
    # predecessor); the A tail is drained by the LAST NON-EMPTY range.
    my_v, my_c, b_offset = exchange_by_rank_range(values, counts, stats=stats)
    if stats is not None:
        stats["exchange_s"] = time.monotonic() - t1
    first = int(my_v[0]) if my_v.size else -1
    firsts = _allgather_i64(np.asarray([first])).reshape(-1)

    def next_first(p):
        for q in range(p + 1, nproc):
            if firsts[q] >= 0:
                return np.int64(firsts[q])
        return np.int64(2**62)

    nonempty = [q for q in range(nproc) if firsts[q] >= 0]
    drain_pid = nonempty[-1] if nonempty else 0
    lo = np.int64(0) if pid == 0 else next_first(pid - 1)
    hi = next_first(pid)
    return my_v, my_c, b_offset, int(lo), hi, pid == drain_pid, False


def multihost_rank_array(a_idx, b_idx, a_sequences: int, b_sequences: int,
                         mesh=None):
    """The whole rank array on every process, (values, counts, False), for
    callers that need it: built ON TOP of the rank-range exchange (each
    process dedups only its own range) and one all-gather that moves each
    merged run once.  Merges should prefer multihost_merge_to_file, which
    never holds more than O(|RA|/P) a process."""
    pid, nproc = process_info()
    if nproc == 1:
        return _local_rank_array(a_idx, b_idx, a_sequences, b_sequences,
                                 mesh)
    my_v, my_c = multihost_rank_array_ranged(a_idx, b_idx, a_sequences,
                                             b_sequences, mesh)[:2]
    all_n = _allgather_i64(np.asarray([my_v.size])).reshape(-1)
    width = max(int(all_n.max()), 1)
    padded = np.zeros((2, width), dtype=np.int64)
    padded[0, :my_v.size] = my_v
    padded[1, :my_v.size] = my_c
    gathered = _allgather_i64(padded.reshape(-1)).reshape(nproc, 2, width)
    # ranges are disjoint and ascending by construction: concatenate
    return (np.concatenate([gathered[p, 0, :int(all_n[p])]
                            for p in range(nproc)]),
            np.concatenate([gathered[p, 1, :int(all_n[p])]
                            for p in range(nproc)]), False)


# -- sharded merge output -------------------------------------------------------


def _range_cursor(lens: np.ndarray, pos: int,
                  cum: Optional[np.ndarray] = None) -> Tuple[int, int]:
    """(run index, remaining-in-run) cursor at absolute position `pos` of an
    RLE stream (prefix-sum binary search, the host analog of
    interleave.cpp cursor_at).  Pass a precomputed `cum` (np.cumsum(lens))
    when calling per-fragment — recomputing it is O(runs) per call."""
    if pos <= 0:
        return 0, int(lens[0]) if lens.size else 0
    if cum is None:
        cum = np.cumsum(lens)
    run = int(np.searchsorted(cum, pos, side="right"))
    if run >= lens.size:
        return int(lens.size), 0
    return run, int(cum[run] - pos)


def interleave_range_chunks(a_runs, b_runs, ra_chunks, lo: int, hi: int,
                            b_offset: int, last: bool,
                            chunk_runs: int = 1 << 20,
                            a_cum: Optional[np.ndarray] = None,
                            b_cum: Optional[np.ndarray] = None):
    """Generator of merged (syms, lens) run chunks for ONE A-position range
    [lo, hi) of the interleave, given that range's ascending RA chunks and
    the B-rank offset of its first insertion.

    The stateful native kernel is initialized at the range cursors (A at
    position lo, B at rank b_offset); after the RA runs, A is advanced to
    `hi` with a synthetic zero-count entry (`last` drains A's tail
    instead).  The trailing run is NOT withheld — the shard concatenator
    coalesces seams.  Shards produced for consecutive ranges concatenate
    into exactly the full interleave's run stream (up to seam splits).
    """
    from ..native.api import _as_i64, _as_u8, _configure_stream_interleave, _lib

    lib = _lib()
    _configure_stream_interleave(lib)
    a_syms, a_lens = _as_u8(a_runs.syms), _as_i64(a_runs.lens)
    b_syms, b_lens = _as_u8(b_runs.syms), _as_i64(b_runs.lens)

    state = np.zeros(7, np.int64)
    state[0], state[1] = _range_cursor(a_lens, lo, a_cum)
    state[2], state[3] = _range_cursor(b_lens, b_offset, b_cum)
    state[4] = lo

    def run(rv, rc, finish):
        rv, rc = _as_i64(rv), _as_i64(rc)
        # emitted-run bound: A fragments (touched runs + one split per RA
        # run) + B fragments likewise — position spans bound the touched
        # runs but must not drive the allocation (a sparse range's span can
        # be orders of magnitude larger than its run count)
        span = (int(rv[-1]) - int(state[4])) if rv.size else 0
        cap = (min(max(span, 0), a_lens.size + 1)
               + min(int(rc.sum()), b_lens.size + 1) + 2 * rv.size + 16)
        if finish:
            cap += a_lens.size + 2
        out_s = np.empty(cap, np.uint8)
        out_l = np.empty(cap, np.int64)
        n = lib.interleave_chunk(a_syms, a_lens, a_syms.size,
                                 b_syms, b_lens, b_syms.size,
                                 rv, rc, rv.size, 1 if finish else 0,
                                 cap, state, out_s, out_l)
        if n == -1:
            raise ValueError("rank-array range inconsistent with inputs")
        if n < 0:
            raise RuntimeError(f"native interleave_chunk failed (code {n})")
        return out_s[:n], out_l[:n]

    for rv, rc in ra_chunks:
        if len(rv) == 0:
            continue
        s, l = run(rv, rc, finish=False)
        if s.size:
            yield s, l
    if last:
        s, l = run(np.zeros(0, np.int64), np.zeros(0, np.int64), finish=True)
        if s.size:
            yield s, l
    else:
        # advance A to the range end with a zero-count entry, then flush
        # the withheld trailing run (the next shard starts at a_pos = hi).
        # Collapsed (empty, lo == hi) ranges have nothing to advance.
        if hi > int(state[4]):
            s, l = run(np.asarray([hi], np.int64),
                       np.asarray([0], np.int64), finish=False)
            if s.size:
                yield s, l
        if state[6] > 0:
            yield (np.asarray([state[5]], np.uint8),
                   np.asarray([state[6]], np.int64))
            state[6] = 0


def coalesce_run_chunks(chunks):
    """Re-establish maximal runs across a chunk stream whose boundaries may
    split runs (shard seams): withholds each chunk's trailing run and
    merges it with the next chunk's head when the symbols match."""
    pend = None  # (sym, len)
    for syms, lens in chunks:
        if syms.size == 0:
            continue
        syms = np.asarray(syms, np.uint8)
        lens = np.asarray(lens, np.int64)
        if pend is not None:
            if syms[0] == pend[0]:
                lens = lens.copy()
                lens[0] += pend[1]
            else:
                yield (np.asarray([pend[0]], np.uint8),
                       np.asarray([pend[1]], np.int64))
        pend = (int(syms[-1]), int(lens[-1]))
        if syms.size > 1:
            yield syms[:-1], lens[:-1]
    if pend is not None:
        yield (np.asarray([pend[0]], np.uint8),
               np.asarray([pend[1]], np.int64))


def _fragment_seam_plan(n_runs, head_sym, head_len, tail_sym):
    """Cross-fragment run coalescing, decided from per-fragment boundary
    metadata alone (deterministic on every process).  Each coalesced run is
    owned by the fragment contributing its FIRST piece: fragment p drops its
    head run when it continues the pending run, and the owner's tail run
    grows by the absorbed lengths (chains through single-run fragments).
    Returns (drop_head[P] bool, extra_tail[P] int64)."""
    nproc = len(n_runs)
    drop_head = np.zeros(nproc, bool)
    extra_tail = np.zeros(nproc, np.int64)
    pend_owner = -1
    pend_sym = -1
    for p in range(nproc):
        if n_runs[p] == 0:
            continue
        if pend_owner >= 0 and head_sym[p] == pend_sym:
            drop_head[p] = True
            extra_tail[pend_owner] += head_len[p]
            if n_runs[p] == 1:
                continue          # fully absorbed; the pending run lives on
        pend_owner, pend_sym = p, int(tail_sym[p])
    return drop_head, extra_tail


def multihost_merge_to_file(a, b, path: str, fmt: str = "native",
                            shard_dir: Optional[str] = None,
                            device="cuda", mesh=None,
                            stats: Optional[dict] = None) -> None:
    """Fully distributed merge of the FMIs a and b: every process searches
    its block of B on its mesh (default: `device`), receives its A-range of
    the rank array (rank-range exchange), interleaves that range, and
    ENCODES its fragment of the output file's byte stream itself, resuming
    the format's position-dependent 64-byte block rule at its global byte
    offset (native rle codec, support.h:256-282).  Process 0 only writes the
    headers, concatenates the encoded fragment files and (native) stitches
    the per-block sample tables; no process decodes or re-encodes another's
    runs.

    The fragments are coordinated by three small all-gathers: boundary runs
    (seam coalescing), per-fragment character counts (prefix state), and
    64-phase size tables (native.fragment_phase_table) from which every
    process composes the global byte offsets.  Per-process peak: the inputs,
    O(|RA|/P) of rank array and O(output/P) of fragment.  `shard_dir` must
    be shared by the processes (default: the output's directory).
    `stats`, when given, receives those of multihost_rank_array_ranged and
    shard_runs, frag_bytes, frag_offset, and the seconds of the interleave
    of the range (interleave_s) and of the fragment's encoding (encode_s).
    """
    import shutil

    import torch.distributed as dist

    from ..formats.headers import NativeHeader, SGAHeader
    from ..formats.streaming import (NativeFragmentWriter, SGAFragmentWriter,
                                     write_bwt_stream, write_native_tail)
    from ..models.runs import SIGMA, RunArrays
    from ..native import fragment_phase_table

    if fmt not in ("native", "sga"):
        raise ValueError(f"no distributed fragment writer for format: {fmt}")

    pid, nproc = process_info()
    shard_dir = shard_dir or (os.path.dirname(os.path.abspath(path)) or ".")
    my_v, my_c, b_offset, lo, hi, drain, _ = multihost_rank_array_ranged(
        a.device_index(device), b.device_index(device), a.sequences(),
        b.sequences(), mesh=mesh, stats=stats)

    def ra_chunks():
        step = 1 << 20
        for s in range(0, my_v.size, step):
            yield my_v[s:s + step], my_c[s:s + step]

    range_chunks = interleave_range_chunks(
        a.runs, b.runs, ra_chunks(), lo, int(min(hi, np.int64(2**62))),
        b_offset, last=drain)

    if nproc == 1:
        write_bwt_stream(path, fmt, coalesce_run_chunks(range_chunks),
                         a.alpha)
        return

    # --- this process's fragment, as maximal runs ---------------------------
    t0 = time.monotonic()
    parts = list(range_chunks)
    syms = (np.concatenate([p[0] for p in parts]) if parts
            else np.zeros(0, np.uint8))
    lens = (np.concatenate([p[1] for p in parts]) if parts
            else np.zeros(0, np.int64))
    del parts
    frag = RunArrays(syms, lens.astype(np.int64)).coalesced()
    syms, lens = frag.syms, frag.lens
    if stats is not None:
        stats["shard_runs"] = int(syms.size)
        stats["interleave_s"] = time.monotonic() - t0
    t0 = time.monotonic()

    # --- seam plan from boundary metadata (one tiny all-gather) -------------
    meta = np.zeros(4, np.int64)
    if syms.size:
        meta[:] = (syms.size, syms[0], lens[0], syms[-1])
    bounds = _allgather_i64(meta)                       # [P, 4]
    drop_head, extra_tail = _fragment_seam_plan(
        bounds[:, 0], bounds[:, 1], bounds[:, 2], bounds[:, 3])
    if drop_head[pid]:
        syms, lens = syms[1:], lens[1:]
    if extra_tail[pid]:
        lens = lens.copy()
        lens[-1] += extra_tail[pid]

    # --- global prefix state (char counts) + 64-phase size tables -----------
    counts = np.zeros(SIGMA, np.int64)
    for c in range(SIGMA):
        counts[c] = int(np.sum(lens[syms == c], dtype=np.int64))
    tab = fragment_phase_table(syms, lens)              # [2, 64]
    g = _allgather_i64(np.concatenate([counts, tab.reshape(-1)]))
    all_counts = g[:, :SIGMA]                           # [P, SIGMA]
    tabs = g[:, SIGMA:].reshape(nproc, 2, 64)
    # compose the offset chain: fragment p's size depends only on its start
    # phase (offset mod 64), so every process resolves all offsets locally
    off = 0
    start_off = frag_bytes = frag_codes = 0
    total_codes = 0
    for p in range(nproc):
        nb = int(tabs[p, 0, off % 64])
        nc = int(tabs[p, 1, off % 64])
        if p == pid:
            start_off, frag_bytes, frag_codes = off, nb, nc
        total_codes += nc
        off += nb
    total_bytes = off
    total_counts = all_counts.sum(axis=0)
    prefix_counts = (all_counts[:pid].sum(axis=0) if pid
                     else np.zeros(SIGMA, np.int64))

    # --- encode THIS fragment only ------------------------------------------
    frag_path = os.path.join(shard_dir, f".bwtmerge_frag_{pid}.bytes")
    samp_path = os.path.join(shard_dir, f".bwtmerge_frag_{pid}_samples.npz")
    step = 1 << 20
    with open(frag_path, "wb") as f:
        if fmt == "sga":
            w = SGAFragmentWriter(f, start_off)
            for s in range(0, syms.size, step):
                w.write_chunk(syms[s:s + step], lens[s:s + step])
            if w.n_codes != frag_codes:
                raise RuntimeError(f"SGA fragment {pid}: {w.n_codes} codes, "
                                   f"the phase table said {frag_codes}")
        else:
            w = NativeFragmentWriter(f, start_off, prefix_counts)
            for s in range(0, syms.size, step):
                w.write_chunk(syms[s:s + step], lens[s:s + step])
            if w.n_bytes_written - start_off != frag_bytes:
                raise RuntimeError(
                    f"native fragment {pid}: {w.n_bytes_written - start_off}"
                    f" bytes, the phase table said {frag_bytes}")
            ids, end, cc = w.finish()
            np.savez(samp_path, ids=ids, end=end, cc=cc)
    if stats is not None:
        stats["frag_bytes"] = int(frag_bytes)
        stats["frag_offset"] = int(start_off)
        stats["encode_s"] = time.monotonic() - t0

    dist.barrier()

    # --- process 0: headers + byte concatenation + sample stitch ------------
    if pid == 0:
        alpha = type(a.alpha)(
            char2comp=a.alpha.char2comp.copy(),
            comp2char=a.alpha.comp2char.copy(),
            C=(a.alpha.C.astype(np.int64)
               + b.alpha.C.astype(np.int64)).astype(np.uint64))
        with open(path, "wb") as out:
            if fmt == "sga":
                out.write(SGAHeader(sequences=int(total_counts[0]),
                                    bases=int(total_counts.sum()),
                                    bytes_=total_codes).to_bytes())
            else:
                out.write(b"\x00" * (NativeHeader.SIZE + 8))
            for p in range(nproc):
                fp = os.path.join(shard_dir, f".bwtmerge_frag_{p}.bytes")
                with open(fp, "rb") as src:
                    shutil.copyfileobj(src, out, 16 * 1024 * 1024)
                os.remove(fp)
            if fmt == "native":
                ids_l, end_l, cc_l = [], [], []
                for p in range(nproc):
                    sp = os.path.join(shard_dir,
                                      f".bwtmerge_frag_{p}_samples.npz")
                    with np.load(sp) as z:
                        ids_l.append(z["ids"])
                        end_l.append(z["end"])
                        cc_l.append(z["cc"])
                    os.remove(sp)
                ids = np.concatenate(ids_l)
                end = np.concatenate(end_l)
                cc = np.vstack(cc_l)
                # seam blocks are reported by both neighbours; the LATER row
                # carries the complete cumulative stats (global prefix state)
                keep = np.ones(ids.size, bool)
                keep[:-1] = ids[:-1] != ids[1:]
                write_native_tail(out, total_bytes, end[keep], cc[keep],
                                  total_counts, alpha)
    dist.barrier()
