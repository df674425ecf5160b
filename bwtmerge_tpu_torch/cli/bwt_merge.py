"""bwt_merge on a torch device: merge BWTs of read collections, with -v
verification.

Usage: python -m bwtmerge_tpu_torch.cli.bwt_merge [options] input1 input2
       [input3 ...] output

Port of bwtmerge_tpu/cli/bwt_merge.py.  More than two inputs run the k-way
fold (models/kfold.py), which decodes every piece's reads on the device.
--fold chain, --checkpoint, a non-streaming output format, or two inputs
select the left fold of pairwise merges instead; --low-memory folds file to
file (models/merge.merge_files).  A pairwise merge walks B's reads where it
has their text: its read-text sidecar (`B.reads4`), or, with --search walk,
B decoded on the device and cached as its sidecar.  Every other B (no
sidecar under --search auto, no reads, reads of 2^14 or more characters,
or --search trie) goes through the trie search, which needs no read text.
--backend numpy searches on the host in -s sequence blocks and emits into
the spill ladder that -r, -b and -m size, under -d; its -v counts on the
host too.  On the torch backend the rank array streams from the device
in blocks held in host memory up to -r x -m runs; past that they drain
into the spill ladder under -d, compacted every -b MB; -s counts the
trie's sequence blocks on a mesh.  --profile DIR writes a torch.profiler
Chrome trace of every merge into DIR.

-t N searches a pairwise merge over a mesh of N devices
(parallel/mesh.py): cuda:0 .. cuda:N-1 with --device cuda, which exits
with status 1 when fewer GPUs are visible, or N CPU entries with --device
cpu.  --index-placement sharded splits both record tables over the mesh
(ops/rank_sharded.py); 'auto' does so when they exceed --hbm-budget-mb.
The k-way fold runs on one device whatever -t says, as in the JAX CLI.
Exit status 2 means the -v pattern counts of the output differ from the
inputs' sum.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..formats.streaming import STREAM_WRITERS
from ..kernels import resolve_device
from ..models.fmi import load_fmi, serialize_fmi
from ..models.merge import (MergeConfig, merge_files, merge_fmi,
                            merge_fmi_to_file)
from ..ops.rank_torch import PatternBatch
from ..utils.metrics import in_megabytes
from .common import (check_format, print_formats, read_rows, report_totals,
                     verify_fmi)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwt_merge", add_help=True,
        description="Merge BWTs of DNA read collections on a torch device.",
        epilog="Formats: native, plain_default, plain_sorted, rfm, sdsl, "
               "ropebwt, sga")
    p.add_argument("files", nargs="+", metavar="FILE",
                   help="input1 input2 [input3 ...] output")
    p.add_argument("-r", dest="run_buffer", type=int, default=None,
                   metavar="N",
                   help="run buffer size in millions of runs (default 8)")
    p.add_argument("-b", dest="thread_buffer", type=int, default=None,
                   metavar="MB",
                   help="thread buffer size in megabytes (default 256)")
    p.add_argument("-m", dest="merge_buffers", type=int, default=None,
                   metavar="N", help="number of merge buffers (default 6)")
    p.add_argument("-s", dest="sequence_blocks", type=int, default=None,
                   metavar="N",
                   help="sequence blocks of the numpy backend's search, and "
                        "of the trie search on a mesh: more than -t take "
                        "the dynamic block queue (default 4)")
    p.add_argument("-t", dest="devices", type=int, default=None, metavar="N",
                   help="search a pairwise merge over a mesh of N devices "
                        "(default 1)")
    p.add_argument("--index-placement", dest="index_placement",
                   default="auto", choices=("auto", "replicated", "sharded"),
                   help="index placement on a mesh: a whole index on every "
                        "device, record tables split over the mesh, or by "
                        "size (default auto)")
    p.add_argument("--hbm-budget-mb", dest="hbm_budget_mb", type=int,
                   default=None, metavar="MB",
                   help="per-device memory budget driving --index-placement "
                        "auto (default: half of the smallest device's "
                        "memory); one device always holds the whole index")
    p.add_argument("--backend", default="torch", choices=("numpy", "torch"),
                   help="compute backend: the torch device, or the host "
                        "search into the spill ladder (default torch)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of each merge "
                        "to DIR (view with Perfetto)")
    p.add_argument("--list-formats", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("-d", dest="temp_dir", default=".", metavar="DIR",
                   help="temp directory for rank-array spills and "
                        "intermediate folds (default .)")
    p.add_argument("-v", dest="patterns", default=None, metavar="FILE",
                   help="verify pattern counts before/after the merge")
    p.add_argument("-i", dest="input_formats", default=None,
                   metavar="FMT[,FMT...]",
                   help="input format(s), comma separated (default native)")
    p.add_argument("-o", dest="output_format", default="native", metavar="FMT",
                   help="output format (default native)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--device-blocks", dest="device_blocks", type=int,
                   default=None, metavar="N",
                   help="blocks of B's reads searched one after the other: "
                        "block k's rank-array copy overlaps block k+1's "
                        "search (default: auto)")
    p.add_argument("--search", default="auto",
                   choices=("auto", "walk", "trie"),
                   help="search engine: 'auto' walks B's reads when B has a "
                        "read-text sidecar and searches the reverse trie "
                        "otherwise; 'walk' decodes B's reads on the device "
                        "when it has no sidecar, and caches them as one; "
                        "'trie' never reads a sidecar (default auto)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="checkpoint each pairwise merge to DIR and resume an "
                        "interrupted fold from the last completed merge")
    p.add_argument("--hash", action="store_true", dest="print_hash",
                   help="print the FNV-1a content hash of the merged BWT")
    p.add_argument("--stream", action="store_true",
                   help="stream the final merged BWT straight to the output "
                        "file (native/sga only)")
    p.add_argument("--low-memory", action="store_true", dest="low_memory",
                   help="file-to-file left fold: inputs are released before "
                        "each merge phase, which re-reads them in bounded "
                        "windows; streaming output formats only")
    p.add_argument("--fold", default="auto", choices=("auto", "kway", "chain"),
                   help="k-way strategy: 'kway' folds all inputs at once by "
                        "pairwise rank-array decomposition (no intermediate "
                        "merged index; streaming output formats); 'chain' is "
                        "the left fold of pairwise merges; 'auto' picks kway "
                        "when eligible (default)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress output")
    return p


def _load_checkpoint(ckpt_dir, inputs):
    """(next input index, FMI or None, pre counts or None); the JAX CLI's
    checkpoint layout, so either can resume the other's."""
    if not ckpt_dir:
        return 1, None, None
    state_path = os.path.join(ckpt_dir, "state.json")
    if not os.path.exists(state_path):
        return 1, None, None
    with open(state_path) as f:
        state = json.load(f)
    completed = int(state.get("completed", 0))
    if state.get("inputs") != inputs or completed < 1:
        print("bwt_merge: checkpoint input list does not match; starting "
              "fresh", file=sys.stderr)
        return 1, None, None
    ckpt = os.path.join(ckpt_dir, f"fold_{completed}.native")
    if not os.path.exists(ckpt):
        return 1, None, None
    index = load_fmi(ckpt, "native")
    pre = np.asarray(state.get("pre", []), dtype=np.int64)
    return completed + 1, index, pre if pre.size else None


def _save_checkpoint(ckpt_dir, inputs, completed, index, pre) -> None:
    if not ckpt_dir:
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    serialize_fmi(index, os.path.join(ckpt_dir, f"fold_{completed}.native"),
                  "native")
    tmp = os.path.join(ckpt_dir, "state.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"inputs": inputs, "completed": completed,
                   "pre": pre.tolist()}, f)
    os.replace(tmp, os.path.join(ckpt_dir, "state.json"))
    prev = os.path.join(ckpt_dir, f"fold_{completed - 1}.native")
    if os.path.exists(prev):
        os.remove(prev)


class _Run:
    """What every merge route shares: parsed arguments, the device, the
    merge config, the patterns and their pre/post counts.  `device` is
    None under --backend numpy: -v then counts on the host.  The patterns'
    PatternBatch is built by the run's first count, inside its time, and
    reused by the later ones."""

    def __init__(self, args, inputs, in_formats, output, device, config):
        self.args = args
        self.inputs = inputs
        self.in_formats = in_formats
        self.output = output
        self.device = device
        self.config = config
        self.verbose = not args.quiet
        self.patterns = read_rows(args.patterns) if args.patterns else []
        self.batch = PatternBatch(self.patterns)
        self.pre = np.zeros(len(self.patterns), dtype=np.int64)
        self.post = np.zeros(len(self.patterns), dtype=np.int64)
        self.start = time.monotonic()

    def verify(self, fmi, role: str) -> None:
        verify_fmi(fmi, role, self.batch,
                   self.pre if role == "Input" else self.post,
                   verbose=self.verbose, device=self.device)

    def verify_inputs(self) -> None:
        """-v of every input, one loaded at a time (file-to-file routes)."""
        if self.patterns:
            for name, fmt in zip(self.inputs, self.in_formats):
                self.verify(load_fmi(name, fmt), "Input")

    def trace(self):
        """--profile: a trace of the region into the directory given."""
        return self.config.timer.device_trace(self.args.profile,
                                              self.device or "cpu")

    def rate(self, what: str, bases: int, since: float) -> None:
        if self.verbose:
            secs = time.monotonic() - since
            print(f"Merged {what}: "
                  f"{in_megabytes(bases) / max(secs, 1e-9):.2f} MB/s")

    def check_output(self, index) -> int:
        """-v of the merged index, its hash, and the exit status."""
        self.verify(index, "Output")
        if self.args.print_hash:
            print(f"Hash:             {index.hash():016x}")
        status = 0
        if self.patterns:
            errors = int(np.sum(self.pre != self.post))
            if errors:
                print(f"Verification failed for {errors} patterns")
                status = 2
            else:
                print("Verification successful")
            print("")
        return status

    def check_output_file(self) -> int:
        if not (self.patterns or self.args.print_hash):
            return 0
        return self.check_output(load_fmi(self.output,
                                          self.args.output_format))

    def done(self, status: int, bases_added: int) -> int:
        if self.verbose:
            report_totals(time.monotonic() - self.start, bases_added)
        return status


def _kway_merge(run: _Run) -> int:
    """All inputs in one k-way fold (models/kfold.merge_files_many): no
    intermediate merged index, O(window) host memory."""
    from ..models.kfold import merge_files_many

    run.verify_inputs()
    stats: dict = {}
    merge_start = time.monotonic()
    with run.trace():
        merge_files_many(run.inputs, run.output, run.in_formats,
                         run.args.output_format, run.config, stats=stats)
    bases_added = sum(stats["piece_bases"][1:])
    run.rate(f"{len(run.inputs)} inputs in one k-way fold", bases_added,
             merge_start)
    return run.done(run.check_output_file(), bases_added)


def _low_memory_merge(run: _Run) -> int:
    """File-to-file left fold through merge_files: no fold holds its inputs
    and its output together.  Intermediates are native-format temp files in
    the temp directory, each removed once the next fold has read it."""
    args = run.args
    if args.output_format not in STREAM_WRITERS:
        print(f"bwt_merge: --low-memory needs a streaming output format "
              f"({', '.join(sorted(STREAM_WRITERS))}), not "
              f"'{args.output_format}'", file=sys.stderr)
        return 1
    if args.checkpoint:
        print("Warning: --checkpoint ignored with --low-memory (every "
              "intermediate fold is already a file)", file=sys.stderr)
    run.verify_inputs()

    bases_added = 0
    cur, cur_fmt = run.inputs[0], run.in_formats[0]
    temps = []
    try:
        for i in range(1, len(run.inputs)):
            if i == len(run.inputs) - 1:
                dst, dst_fmt = run.output, args.output_format
            else:
                fd, dst = tempfile.mkstemp(suffix=".native",
                                           prefix=".bwtmerge_fold_",
                                           dir=run.config.temp_dir)
                os.close(fd)
                temps.append(dst)
                dst_fmt = "native"
            merge_start = time.monotonic()
            stats: dict = {}
            with run.trace():
                merge_files(cur, run.inputs[i], dst, in_fmt=cur_fmt,
                            out_fmt=dst_fmt, config=run.config, stats=stats,
                            in_fmt_b=run.in_formats[i])
            bases_added += stats["b_bases"]
            run.rate(run.inputs[i], stats["b_bases"], merge_start)
            if cur in temps:
                os.remove(cur)
            cur, cur_fmt = dst, dst_fmt
    finally:
        for path in temps:
            if os.path.exists(path):
                os.remove(path)
    return run.done(run.check_output_file(), bases_added)


def _chain_merge(run: _Run) -> int:
    """Left fold of pairwise in-memory merges, checkpointed after each merge
    with --checkpoint; the last merge streams to the file with --stream."""
    args = run.args
    start_at, index, pre_restore = _load_checkpoint(args.checkpoint,
                                                    run.inputs)
    if index is None:
        index = load_fmi(run.inputs[0], run.in_formats[0])
        run.verify(index, "Input")
        start_at = 1
    else:
        if run.verbose:
            print(f"Resuming after {start_at - 1} merged increment(s) from "
                  f"{args.checkpoint}")
        if pre_restore is not None and pre_restore.size == run.pre.size:
            run.pre[:] = pre_restore

    stream_last = (args.stream and args.output_format in STREAM_WRITERS
                   and not args.checkpoint)
    if args.stream and not stream_last:
        reason = ("--checkpoint holds the merged index in memory between "
                  "folds" if args.checkpoint else
                  f"output format '{args.output_format}' has no streaming "
                  "writer")
        print(f"Warning: --stream ignored ({reason}); merging fully in "
              "memory", file=sys.stderr)

    bases_added = 0
    streamed_out = False
    for i in range(start_at, len(run.inputs)):
        name = run.inputs[i]
        increment = load_fmi(name, run.in_formats[i])
        bases_added += increment.size()
        run.verify(increment, "Input")
        merge_start = time.monotonic()
        with run.trace():
            if stream_last and i == len(run.inputs) - 1:
                merge_fmi_to_file(index, increment, run.output,
                                  args.output_format, run.config)
                streamed_out = True
            else:
                index = merge_fmi(index, increment, run.config)
        run.rate(name, increment.size(), merge_start)
        if not streamed_out:
            _save_checkpoint(args.checkpoint, run.inputs, i, index, run.pre)

    if streamed_out:
        status = run.check_output_file()
    else:
        serialize_fmi(index, run.output, args.output_format)
        status = run.check_output(index)
    return run.done(status, bases_added)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_formats:
        print_formats(sys.stdout)
        return 0
    if len(args.files) < 3:
        print("bwt_merge: need at least two inputs and an output",
              file=sys.stderr)
        return 1
    inputs, output = args.files[:-1], args.files[-1]

    in_formats = (args.input_formats.split(",") if args.input_formats
                  else ["native"])
    if len(in_formats) == 1:
        in_formats = in_formats * len(inputs)
    if len(in_formats) != len(inputs):
        print(f"bwt_merge: Specified {len(in_formats)} formats for "
              f"{len(inputs)} inputs", file=sys.stderr)
        return 1
    for fmt in in_formats:
        check_format(fmt, "bwt_merge", "input")
    check_format(args.output_format, "bwt_merge", "output")

    # the numpy backend touches no device: its -v counts on the host
    device = resolve_device(args.device) if args.backend == "torch" else None
    config = MergeConfig(device=args.device if device is None else str(device),
                         backend=args.backend, temp_dir=args.temp_dir,
                         verbose=not args.quiet, search=args.search,
                         cache_sidecar=args.search == "walk")
    if args.run_buffer is not None:
        config.run_buffer_runs = args.run_buffer * 1024 * 1024
    if args.thread_buffer is not None:
        config.thread_buffer_mb = args.thread_buffer
    if args.merge_buffers is not None:
        config.merge_buffers = args.merge_buffers
    if args.sequence_blocks is not None:
        config.sequence_blocks = args.sequence_blocks
    if args.hbm_budget_mb is not None:
        config.hbm_budget_bytes = args.hbm_budget_mb << 20
    if args.device_blocks is not None:
        config.device_blocks = args.device_blocks
    if args.devices is not None:
        config.devices = args.devices
    config.index_placement = args.index_placement
    try:
        config.sanitize()
    except RuntimeError as e:       # a mesh of more GPUs than are visible
        print(f"bwt_merge: -t {args.devices}: {e}", file=sys.stderr)
        return 1
    run = _Run(args, inputs, in_formats, output, device, config)

    if run.verbose:
        print("BWT-merge (PyTorch)")
        print("")
        for name, fmt in zip(inputs, in_formats):
            print(f"Input:            {name} ({fmt})")
        print(f"Output:           {output} ({args.output_format})")
        if args.patterns:
            print(f"Patterns:         {args.patterns}")
        print(f"Backend:          {args.backend}")
        if device is not None:
            print(f"Device:           {device}")
        print("")
        if run.patterns:
            chars = sum(len(p) for p in run.patterns)
            print(f"Read {len(run.patterns)} patterns of total length "
                  f"{chars}")
            print("")

    kway_ok = (len(inputs) > 2 and args.backend == "torch"
               and args.output_format in STREAM_WRITERS
               and not args.checkpoint and not args.low_memory)
    route = _chain_merge
    if args.fold == "kway" or (args.fold == "auto" and kway_ok):
        if kway_ok:
            route = _kway_merge
        else:
            print("bwt_merge: --fold kway unavailable (needs >2 inputs, "
                  "--backend torch, a streaming output format, and no "
                  "--checkpoint/--low-memory); falling back to the pairwise "
                  "chain",
                  file=sys.stderr)
    if route is _chain_merge and args.low_memory:
        route = _low_memory_merge
    return route(run)


if __name__ == "__main__":
    sys.exit(main())
