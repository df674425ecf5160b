"""Chain-stage subprocess for the k-way fold (models/kfold.py).

The fold's interleave chain is k-1 windowed passes; as threads they
serialize on the GIL (the native interleave releases it, but window
bookkeeping, spill decode, and chunk plumbing are Python/numpy).  Running
each stage as its OWN PROCESS, connected by pipes, turns the chain into real multi-core pipeline parallelism — the
reference's producer/consumer threads (bwt.cpp:152-190) mapped to
processes because CPython threads cannot overlap the host-side work.

Stage child k:
  stdin   framed merged-run chunks from stage k-1 (or reads piece 0's file
          itself when argv says so)
  argv    the piece file it merges in, and the step's drained rank-array
          spill files (durable on disk by the time the child is spawned)
  stdout  framed merged-run chunks for stage k+1 / the parent's writer

Frame layout (little-endian), chosen so a run costs ~2 B on the pipe:
  u32 n   (0 = end of stream)  u32 n_exc
  u8  syms[n]
  u8  lens8[n]                 (min(len, 255))
  u32 exc_idx[n_exc]           (runs whose length >= 255)
  u64 exc_len[n_exc]

Children import neither torch nor any device code.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

_HDR = struct.Struct("<II")


def write_frame(out, syms: np.ndarray, lens: np.ndarray) -> None:
    syms = np.ascontiguousarray(syms, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    exc = np.flatnonzero(lens >= 255)
    lens8 = np.minimum(lens, 255).astype(np.uint8)
    out.write(_HDR.pack(syms.size, exc.size))
    out.write(syms.tobytes())
    out.write(lens8.tobytes())
    if exc.size:
        out.write(exc.astype(np.uint32).tobytes())
        out.write(lens[exc].astype(np.uint64).tobytes())


def write_end(out) -> None:
    out.write(_HDR.pack(0, 0))
    out.flush()


def _read_exact(inp, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        b = inp.read(n - len(buf))
        if not b:
            raise EOFError("stage pipe closed mid-frame")
        buf += b
    return bytes(buf)


def read_frames(inp):
    """Yield (syms, lens) chunks until the end frame."""
    while True:
        n, n_exc = _HDR.unpack(_read_exact(inp, _HDR.size))
        if n == 0 and n_exc == 0:
            return
        syms = np.frombuffer(_read_exact(inp, n), np.uint8)
        lens = np.frombuffer(_read_exact(inp, n), np.uint8).astype(np.int64)
        if n_exc:
            idx = np.frombuffer(_read_exact(inp, 4 * n_exc), np.uint32)
            ex = np.frombuffer(_read_exact(inp, 8 * n_exc), np.uint64)
            lens = lens.copy()
            lens[idx.astype(np.int64)] = ex.astype(np.int64)
        yield syms, lens


SPILL_CHUNK_RUNS = 4 * 1024 * 1024   # runs a spill file's read takes


def spill_stream(spill_files):
    """Ascending (values, counts) chunks from drained spill files
    [(path, n_runs)], each sorted-unique.  Their ranges may overlap (a step
    of several lane blocks drains blocks that each span the whole range),
    so several files are merged, duplicate values summed, as
    RankArraySpill.stream merges them; one file is streamed as it is.  Each
    file is deleted once read."""
    from .spill import _SpillFile, merge_ra_chunk_streams

    def file_chunks(f):
        try:
            while not f.done():
                f.refill(SPILL_CHUNK_RUNS)
                v, c = f.take_until(np.iinfo(np.int64).max)
                if v.size:
                    yield v, c
        finally:
            f.delete()

    streams = [file_chunks(_SpillFile(path, int(n)))
               for path, n in spill_files]
    if len(streams) == 1:
        yield from streams[0]
    else:
        yield from merge_ra_chunk_streams(streams,
                                          chunk_runs=SPILL_CHUNK_RUNS)


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="kfold_stage")
    p.add_argument("--a-path", default=None,
                   help="read the A side from this BWT file (stage 1); "
                        "otherwise A arrives framed on stdin")
    p.add_argument("--a-fmt", default="native")
    p.add_argument("--b-path", required=True)
    p.add_argument("--b-fmt", required=True)
    p.add_argument("--spill", nargs="+", required=True,
                   help="path:n_runs of the step's drained rank array")
    p.add_argument("--window", type=int, default=1 << 24)
    args = p.parse_args(argv)

    from ..formats.streaming_read import read_bwt_chunks
    from ..native.windowed import interleave_windowed_chunks

    if args.a_path:
        a_chunks = read_bwt_chunks(args.a_path, args.a_fmt)
    else:
        a_chunks = read_frames(sys.stdin.buffer)
    b_chunks = read_bwt_chunks(args.b_path, args.b_fmt)
    spills = []
    for s in args.spill:
        path, n = s.rsplit(":", 1)
        spills.append((path, int(n)))

    out = sys.stdout.buffer
    for syms, lens in interleave_windowed_chunks(
            a_chunks, b_chunks, spill_stream(spills),
            window_positions=args.window):
        write_frame(out, syms, lens)
    write_end(out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
