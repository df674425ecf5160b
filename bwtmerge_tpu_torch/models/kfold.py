"""K-way fold orchestration on one torch device.

Port of bwtmerge_tpu/models/kfold.py.  The left fold of pairwise merges is
re-derived so that no intermediate merged index is built (ops/kfold_torch.py
for the math):

  device  one resident cplane index per piece; every piece after the first
          is decoded on the device (kernel K3) and walked through each
          earlier piece (kernel K2); the summed lanes are sorted and reduced
          to (value, count) pairs per lane block
  drain   a background thread dispatches each fold step's blocks and copies
          their pairs to pinned host memory on a side stream, then into an
          on-disk spill ladder (models/spill.py), in fold order
  host    k-1 windowed interleave passes (native/windowed.py), chained as
          threads or as subprocess stages (models/kfold_stage.py), so peak
          host memory is O(window)

The fold walks, so it needs every piece's reads decoded within the walk's
cap.  Where a piece has a read of WALK_MAX_LEN or more characters, or the
caller asks for search='trie', the inputs go through the left fold of
pairwise merges with the trie search instead, as in the JAX package.
"""

from __future__ import annotations

import copy
import os
import queue
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

from ..kernels import resolve_device
from ..utils.alphabet import Alphabet
from .fmi import FMI
from .merge import WALK_MAX_LEN, MergeConfig
from .runs import RunArrays

# spill ladder of each drained fold step: the JAX package's defaults
# (run_buffer_runs * merge_buffers, thread_buffer_mb / 16 B per run)
SPILL_THRESHOLD_RUNS = 48 * 1024 * 1024
COMPACT_EVERY_RUNS = 16 * 1024 * 1024
DRAIN_CHUNK_RUNS = 2 * 1024 * 1024
_POLL_S = 0.1


def _alpha_sum(alphas: List[Alphabet]) -> Alphabet:
    a0 = alphas[0]
    C = a0.C.astype(np.int64).copy()
    for a in alphas[1:]:
        if a != a0:
            raise ValueError("cannot merge BWTs with different alphabets")
        C += a.C.astype(np.int64)
    return type(a0)(char2comp=a0.char2comp.copy(),
                    comp2char=a0.comp2char.copy(),
                    C=C.astype(np.uint64))


class _PieceTooLong(Exception):
    """A fold piece has a read of WALK_MAX_LEN or more characters."""


def _trie_chain_config(config: MergeConfig) -> MergeConfig:
    chain = copy.copy(config)
    chain.search = "trie"
    return chain


def _note_chain_fallback() -> None:
    print("kfold: piece reads exceed the walk cap; falling back to the "
          "pairwise chain", file=sys.stderr)


class _FoldDevice:
    """Device residency and fold-step dispatch.  Pieces register in fold
    order; step k walks piece k through pieces 0..k-1."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self.targets = []   # PieceIndex per registered piece (None if unused)

    def add_piece(self, payload, counts: np.ndarray, need_creads: bool,
                  need_index: bool):
        """Upload a piece, derive its cplanes when later pieces walk through
        it, and decode its reads on the device when it walks.  The record
        table is dropped on return.

        payload: RunArrays (in-memory pieces) or ("nib", nibbles, size) from
        the chunked file loader."""
        from ..ops.decode_torch import decode_creads_dev
        from ..ops.kfold_torch import PieceIndex
        from ..ops.rank_torch import DeviceFMIndex

        if isinstance(payload, tuple) and payload[0] == "nib":
            _, nibbles, size = payload
            idx = DeviceFMIndex.from_nibbles(nibbles, counts, size,
                                             device=self.device)
        else:
            idx = DeviceFMIndex.build(payload, counts, self.device)
        creads = None
        if need_creads:
            dec = decode_creads_dev(idx, int(counts[0]), idx.size,
                                    max_len_cap=WALK_MAX_LEN)
            if dec is None:
                raise _PieceTooLong()
            creads = dec[0]
        self.targets.append(PieceIndex.from_device_index(idx)
                            if need_index else None)
        return creads

    def step_part_thunks(self, k: int, creads):
        """Per-lane-block thunks of step k (piece k against pieces 0..k-1);
        each returns its block's (values, counts) on the device."""
        from ..ops.kfold_torch import summed_part_thunks

        targets = self.targets[:k]
        if any(t is None for t in targets):
            raise RuntimeError(f"fold step {k}: an earlier piece has no index")
        return summed_part_thunks(targets, creads)


def merge_fmi_many(fmis: List[FMI], config: Optional[MergeConfig] = None
                   ) -> FMI:
    """K-way merge of in-memory FMIs: the fold for three or more inputs,
    the left fold of pairwise merge_fmi for two, under search='trie', and
    where a piece's reads are too long for the walk."""
    from .merge import merge_fmi

    config = (config or MergeConfig()).sanitize()
    if not fmis:
        raise ValueError("merge_fmi_many needs at least one input")
    if len(fmis) == 1:
        return fmis[0]
    alpha = _alpha_sum([f.alpha for f in fmis])
    if len(fmis) > 2 and config.search != "trie":
        try:
            chunks = _fold_chain_chunks(
                len(fmis), lambda k: (fmis[k].runs, fmis[k].alpha), config,
                a_chunks=fmis[0].runs.iter_chunks(1 << 20),
                piece_chunks=lambda k: fmis[k].runs.iter_chunks(1 << 20))
            return FMI(runs=_materialize(chunks), alpha=alpha)
        except _PieceTooLong:
            _note_chain_fallback()
            config = _trie_chain_config(config)
    acc = fmis[0]
    for f in fmis[1:]:
        acc = merge_fmi(acc, f, config)
    return acc


def merge_files_many(paths: List[str], out_path: str, in_fmts,
                     out_fmt: str = "native",
                     config: Optional[MergeConfig] = None,
                     window_positions: int = 1 << 24,
                     stats: Optional[dict] = None,
                     chain: str = "procs") -> None:
    """K-way streaming file merge (streaming output formats only).

    Three or more inputs run the fold; two, any number under search='trie',
    and inputs with a read too long for the walk run the left fold of
    pairwise merge_files through native-format files in config.temp_dir.
    In the fold each piece's runs are resident only while its nibbles are packed and
    uploaded; the interleave chain re-reads every file in bounded windows.
    The output is written to a temporary file beside out_path and renamed
    over it only when complete.  `stats` receives piece_bases (every
    input's size) on every route, plus the fold's step timings.  `chain`
    runs the interleave passes as 'procs' (subprocess stages, one core
    each) or 'threads'."""
    from ..formats.streaming import write_bwt_stream
    from ..formats.streaming_read import alphabet_for, read_bwt_chunks
    from ..ops.rank_torch import pack_nibbles_chunked
    from .merge import merge_files

    config = (config or MergeConfig()).sanitize()
    config.timer.verbose = config.verbose
    if isinstance(in_fmts, str):
        in_fmts = [in_fmts] * len(paths)
    if len(paths) < 2:
        raise ValueError("merge_files_many needs at least two inputs")
    if len(in_fmts) != len(paths):
        raise ValueError(f"{len(in_fmts)} formats for {len(paths)} inputs")
    if stats is None:
        stats = {}

    fd, tmp_out = tempfile.mkstemp(
        prefix=".bwtmerge_out_",
        dir=os.path.dirname(os.path.abspath(out_path)))
    os.close(fd)

    def chain_files(chain_config):
        """Left fold of pairwise merge_files; the last merge writes
        tmp_out."""
        bases = []
        cur, cur_fmt = paths[0], in_fmts[0]
        with tempfile.TemporaryDirectory(dir=config.temp_dir,
                                         prefix=".bwtmerge_fold_") as tmpdir:
            for k in range(1, len(paths)):
                last = k == len(paths) - 1
                dst = tmp_out if last else os.path.join(tmpdir,
                                                        f"fold_{k}.native")
                dst_fmt = out_fmt if last else "native"
                merge_files(cur, paths[k], dst, cur_fmt, dst_fmt,
                            chain_config, window_positions, stats,
                            in_fmt_b=in_fmts[k])
                bases.append(stats["b_bases"])
                if k == 1:
                    bases.insert(0, stats["a_bases"])
                elif os.path.exists(cur):
                    os.remove(cur)
                cur, cur_fmt = dst, dst_fmt
        stats["piece_bases"] = bases
        os.replace(tmp_out, out_path)

    try:
        if len(paths) == 2 or config.search == "trie":
            chain_files(config)
            return

        def loader(k):
            # chunk-stream the file straight into the 0.5 B/position upload
            # layout; the piece's run arrays never exist on the host
            nib, counts, size, _ = pack_nibbles_chunked(
                read_bwt_chunks(paths[k], in_fmts[k]))
            al = alphabet_for(in_fmts[k], counts, paths[k])
            if al.size() != size:
                raise ValueError(f"{paths[k]}: header size {al.size()} != "
                                 f"decoded size {size}")
            return ("nib", nib, size), al

        alphas = [None] * len(paths)
        ready = threading.Event()
        error = [None]
        chunks = _fold_chain_chunks(
            len(paths), loader, config,
            a_chunks=read_bwt_chunks(paths[0], in_fmts[0]),
            piece_chunks=lambda k: read_bwt_chunks(paths[k], in_fmts[k]),
            window_positions=window_positions, stats=stats,
            alphas_out=alphas, ready_event=ready, error_out=error,
            chain=chain, piece_files=list(zip(paths, in_fmts)))
        too_long = False
        try:
            with config.timer.phase("fold chain (interleave+write)"):
                # only the writer needs the summed alphabet, so the wait for
                # every piece's header overlaps the uploads; the first chunk is
                # pulled before the writer starts, so loader errors surface
                # before any output byte
                it = iter(chunks)
                peek = next(it, None)
                ready.wait()
                if error[0] is not None:
                    raise error[0]
                alpha = _alpha_sum(alphas)
                stats["piece_bases"] = [int(a.size()) for a in alphas]

                def with_peek():
                    if peek is not None:
                        yield peek
                        yield from it

                write_bwt_stream(tmp_out, out_fmt, with_peek(), alpha)
        except _PieceTooLong:
            too_long = True
        finally:
            chunks.close()     # an abandoned chain stops its stages
        if too_long:
            _note_chain_fallback()
            chain_files(_trie_chain_config(config))
            return
        os.replace(tmp_out, out_path)
    finally:
        if os.path.exists(tmp_out):
            os.remove(tmp_out)
    if config.verbose:
        config.timer.report(sum(stats["piece_bases"]))


def _fold_chain_chunks(k_total: int, loader, config: MergeConfig, a_chunks,
                       piece_chunks, window_positions: int = 1 << 24,
                       stats: Optional[dict] = None,
                       alphas_out: Optional[list] = None,
                       ready_event=None, error_out=None,
                       chain: str = "threads", piece_files=None):
    """Build the device fold and the host interleave chain; returns the
    merged run-chunk generator (ascending, maximal-run-clean chunks).

    loader(k) -> (payload, Alphabet) loads piece k; a_chunks/piece_chunks
    feed the chain's inputs, so piece runs need not stay resident.  With a
    ready_event the piece loop runs on its own thread (file folds); without
    one it runs here, before the chain starts."""
    import concurrent.futures

    from ..native.windowed import interleave_windowed_chunks
    from ..utils.pipeline import prefetch_chunks

    dev = _FoldDevice(config.device)
    steps = _StepDrainer(dev, k_total - 1, config.temp_dir, stats=stats,
                         verbose=config.verbose)
    if stats is not None:
        stats["fold_steps"] = k_total - 1

    def produce():
        """Upload pieces and hand each step's reads to the drainer: piece
        k+1's host read and pack overlap piece k's upload and decode."""
        t0 = time.monotonic()
        pool = concurrent.futures.ThreadPoolExecutor(1)
        nxt = None
        try:
            with config.timer.phase("device fold dispatch"):
                for k in range(k_total):
                    payload, al = nxt.result() if nxt is not None \
                        else loader(k)
                    nxt = (pool.submit(loader, k + 1)
                           if k + 1 < k_total else None)
                    counts = al.counts()
                    if alphas_out is not None:
                        alphas_out[k] = al
                    creads = dev.add_piece(payload, counts,
                                           need_creads=k > 0,
                                           need_index=k < k_total - 1)
                    if k > 0:
                        steps.push(creads)
                    del creads, payload
                    if stats is not None:
                        stats.setdefault("piece_dispatch_s", []).append(
                            round(time.monotonic() - t0, 2))
                    if config.verbose:
                        print(f"kfold: piece {k} dispatched "
                              f"({time.monotonic() - t0:.1f}s)",
                              file=sys.stderr)
        except BaseException as e:  # noqa: BLE001 - surfaces at consumers
            steps.fail(e)
            if error_out is not None:
                error_out[0] = e
            if ready_event is None:
                raise
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            if ready_event is not None:
                ready_event.set()

    if ready_event is None:
        produce()
    else:
        threading.Thread(target=produce, daemon=True).start()

    if chain == "procs":
        out = _proc_chain_chunks(steps, k_total, piece_files,
                                 window_positions)
    else:
        cur = a_chunks
        for k in range(1, k_total):
            cur = interleave_windowed_chunks(
                prefetch_chunks(cur, depth=2), piece_chunks(k),
                steps.ra_stream(k - 1), window_positions=window_positions,
                stats=stats)
        out = prefetch_chunks(cur, depth=1)
    return steps.guard(out)


def _proc_chain_chunks(steps, k_total: int, piece_files, window: int):
    """The interleave chain as subprocess stages joined by pipes
    (models/kfold_stage.py): each windowed pass runs on its own
    core.  Stage k starts once step k-1's rank array is in its spill files,
    which the child reads and deletes; its A input is the previous stage's
    stdout."""
    import subprocess

    def gen():
        from .kfold_stage import read_frames

        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs = []
        prev = None
        try:
            for k in range(1, k_total):
                steps.wait_spill(k - 1)
                spill_args = [f"{p}:{n}" for p, n in steps.spill_files(k - 1)]
                cmd = [sys.executable, "-m",
                       "bwtmerge_tpu_torch.models.kfold_stage",
                       "--b-path", piece_files[k][0],
                       "--b-fmt", piece_files[k][1],
                       "--window", str(window), "--spill"] + spill_args
                if k == 1:
                    cmd += ["--a-path", piece_files[0][0],
                            "--a-fmt", piece_files[0][1]]
                    stdin = subprocess.DEVNULL
                else:
                    stdin = prev.stdout
                proc = subprocess.Popen(cmd, stdin=stdin,
                                        stdout=subprocess.PIPE, env=env)
                if prev is not None:
                    prev.stdout.close()    # the parent's copy of the pipe
                procs.append(proc)
                prev = proc
            yield from read_frames(prev.stdout)
            for proc in procs:
                if proc.wait() != 0:
                    raise RuntimeError(
                        f"kfold stage exited with {proc.returncode}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if prev is not None and prev.stdout:
                prev.stdout.close()

    return gen()


class _StepDrainer:
    """Background thread that dispatches each fold step's lane blocks as its
    reads arrive and drains their pairs into a host spill ladder, strictly
    in fold order.

    Each block's pairs cross to pinned host memory on a side stream
    (ops/ra_stream.Block), so later blocks' walks overlap earlier blocks'
    copies; two drain workers move them into the step's RankArraySpill and
    at most two blocks are outstanding.  Draining to disk bounds device
    memory: the chain's stages run concurrently, so holding every step's
    pairs on the device until its stage reads them would keep them all
    resident at once.

    No call blocks on a drainer that has died: push, the step loop and the
    consumers all poll the shared error."""

    def __init__(self, dev: _FoldDevice, n_steps: int, temp_dir: str,
                 stats=None, verbose=False):
        self._dev = dev
        self._n = n_steps
        # one step's reads wait at most: they hold device memory
        self._q = queue.Queue(maxsize=1)
        self._spills = [None] * n_steps
        self._events = [threading.Event() for _ in range(n_steps)]
        self._error = [None]
        self._temp_dir = temp_dir
        self._stats = stats
        self._verbose = verbose
        self._t0 = time.monotonic()
        if n_steps:
            threading.Thread(target=self._run, daemon=True).start()

    def push(self, creads) -> None:
        while True:
            self.check()
            try:
                self._q.put(creads, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def fail(self, e: BaseException) -> None:
        if self._error[0] is None:
            self._error[0] = e
        for ev in self._events:
            ev.set()
        try:
            self._q.put_nowait(None)     # wake the step loop
        except queue.Full:
            pass

    def check(self) -> None:
        if self._error[0] is not None:
            raise self._error[0]

    def guard(self, chunks):
        """`chunks`, failing the fold (so its threads stop) if the consumer
        raises or abandons the stream early."""
        try:
            yield from chunks
        except BaseException as e:
            self.fail(e)
            raise

    def _next_step(self):
        while self._error[0] is None:
            try:
                return self._q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return None

    def _new_spill(self):
        from .spill import RankArraySpill

        return RankArraySpill(temp_dir=self._temp_dir,
                              spill_threshold_runs=SPILL_THRESHOLD_RUNS,
                              compact_every=COMPACT_EVERY_RUNS)

    def _finish_step(self, i, spill):
        # the in-memory tail goes to disk too: a drained step waiting for its
        # stage holds file handles, not host runs
        spill._compact()
        if spill._base is not None and spill._base[0].size:
            spill._spill()
        self._spills[i] = spill
        self._events[i].set()
        if self._stats is not None:
            self._stats.setdefault("step_drained_s", []).append(
                round(time.monotonic() - self._t0, 2))
            self._stats.setdefault("step_spill_files", []).append(
                spill.n_spill_files)
        if self._verbose:
            print(f"kfold: step {i} rank array drained "
                  f"({time.monotonic() - self._t0:.1f}s, "
                  f"{spill.n_spill_files} spill files)", file=sys.stderr)

    def _run(self):
        from ..ops.ra_stream import Block

        sem = threading.Semaphore(2)
        work: queue.Queue = queue.Queue()

        def drain_part(i, part, spill, lock, left):
            try:
                for v, c in part.chunks(DRAIN_CHUNK_RUNS):
                    with lock:
                        spill.emit(v, c)
                del part
                with lock:
                    left[0] -= 1
                    last = left[0] == 0
                if last:
                    self._finish_step(i, spill)
            except BaseException as e:  # noqa: BLE001 - surfaces at consumers
                self.fail(e)
            finally:
                sem.release()

        def worker():
            while True:
                item = work.get()
                if item is None:
                    return
                drain_part(*item)

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(2)]
        for w in workers:
            w.start()
        try:
            for i in range(self._n):
                creads = self._next_step()
                if creads is None:
                    return
                thunks = self._dev.step_part_thunks(i + 1, creads)
                del creads
                spill = self._new_spill()
                if not thunks:
                    self._finish_step(i, spill)
                    continue
                lock = threading.Lock()
                left = [len(thunks)]
                for thunk in thunks:
                    while not sem.acquire(timeout=_POLL_S):
                        self.check()
                    self.check()
                    values, counts = thunk()     # this block's walks
                    work.put((i, Block(values, counts), spill, lock, left))
                    del values, counts
                del thunks
        except BaseException as e:  # noqa: BLE001 - surfaces at consumers
            self.fail(e)
        finally:
            for _ in workers:
                work.put(None)

    def ra_stream(self, k: int):
        def gen():
            self.wait_spill(k)
            spill = self._spills[k]
            try:
                yield from spill.stream()
            finally:
                self._spills[k] = None
                for f in spill._files:
                    try:
                        f.delete()
                    except OSError:
                        pass

        return gen()

    def wait_spill(self, k: int) -> None:
        self._events[k].wait()
        self.check()

    def spill_files(self, k: int):
        """[(path, n_runs)] of step k's drained rank array; the consuming
        stage child deletes the files."""
        spill = self._spills[k]
        self._spills[k] = None
        return [(f.path, f.n_runs) for f in spill._files]


def _materialize(chunks) -> RunArrays:
    parts_s, parts_l = [], []
    for s, l in chunks:
        # the chunks are views, valid only until the next one
        parts_s.append(np.array(s, np.uint8, copy=True))
        parts_l.append(np.array(l, np.int64, copy=True))
    if not parts_s:
        return RunArrays.empty()
    return RunArrays(np.concatenate(parts_s),
                     np.concatenate(parts_l).astype(np.int64)).coalesced()
