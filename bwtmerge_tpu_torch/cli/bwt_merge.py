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

Features of later port slices exit with status 1 and name their ROADMAP
item: -t > 1 and --index-placement sharded.  Exit status 2 means the -v
pattern counts of the output differ from the inputs' sum.
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
from ..utils.metrics import in_megabytes
from .common import check_format, read_rows, report_totals, verify_fmi


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwt_merge", add_help=True,
        description="Merge BWTs of DNA read collections on a torch device.",
        epilog="Formats: native, plain_default, plain_sorted, rfm, sdsl, "
               "ropebwt, sga.  Not in this port yet (exit status 1): -t N "
               "with N > 1 and --index-placement sharded.")
    p.add_argument("files", nargs="+", metavar="FILE",
                   help="input1 input2 [input3 ...] output")
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
    # later slices: accepted so that they can be refused by name
    p.add_argument("-t", dest="devices", type=int, default=None, metavar="N",
                   help=argparse.SUPPRESS)
    p.add_argument("--index-placement", dest="index_placement",
                   default="auto", choices=("auto", "replicated", "sharded"),
                   help=argparse.SUPPRESS)
    return p


def _later_slice(args):
    """The ROADMAP item a requested feature waits for, or None."""
    if (args.devices or 1) > 1 or args.index_placement == "sharded":
        return "-t > 1 / --index-placement sharded: ROADMAP A.10 (slice 5)"
    return None


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
    merge config, the patterns and their pre/post counts."""

    def __init__(self, args, inputs, in_formats, output, device, config):
        self.args = args
        self.inputs = inputs
        self.in_formats = in_formats
        self.output = output
        self.device = device
        self.config = config
        self.verbose = not args.quiet
        self.patterns = read_rows(args.patterns) if args.patterns else []
        self.pre = np.zeros(len(self.patterns), dtype=np.int64)
        self.post = np.zeros(len(self.patterns), dtype=np.int64)
        self.start = time.monotonic()

    def verify(self, fmi, role: str) -> None:
        verify_fmi(fmi, role, self.patterns,
                   self.pre if role == "Input" else self.post,
                   verbose=self.verbose, device=self.device)

    def verify_inputs(self) -> None:
        """-v of every input, one loaded at a time (file-to-file routes)."""
        if self.patterns:
            for name, fmt in zip(self.inputs, self.in_formats):
                self.verify(load_fmi(name, fmt), "Input")

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
    if len(args.files) < 3:
        print("bwt_merge: need at least two inputs and an output",
              file=sys.stderr)
        return 1
    inputs, output = args.files[:-1], args.files[-1]
    later = _later_slice(args)
    if later:
        print(f"bwt_merge: not in this port yet: {later}", file=sys.stderr)
        return 1

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

    device = resolve_device(args.device)
    config = MergeConfig(device=str(device), temp_dir=args.temp_dir,
                         verbose=not args.quiet, search=args.search,
                         cache_sidecar=args.search == "walk")
    if args.device_blocks is not None:
        config.device_blocks = args.device_blocks
    config.sanitize()
    run = _Run(args, inputs, in_formats, output, device, config)

    if run.verbose:
        print("BWT-merge (PyTorch)")
        print("")
        for name, fmt in zip(inputs, in_formats):
            print(f"Input:            {name} ({fmt})")
        print(f"Output:           {output} ({args.output_format})")
        if args.patterns:
            print(f"Patterns:         {args.patterns}")
        print(f"Device:           {device}")
        print("")
        if run.patterns:
            chars = sum(len(p) for p in run.patterns)
            print(f"Read {len(run.patterns)} patterns of total length "
                  f"{chars}")
            print("")

    kway_ok = (len(inputs) > 2 and args.output_format in STREAM_WRITERS
               and not args.checkpoint and not args.low_memory)
    route = _chain_merge
    if args.fold == "kway" or (args.fold == "auto" and kway_ok):
        if kway_ok:
            route = _kway_merge
        else:
            print("bwt_merge: --fold kway unavailable (needs >2 inputs, a "
                  "streaming output format, and no --checkpoint/"
                  "--low-memory); falling back to the pairwise chain",
                  file=sys.stderr)
    if route is _chain_merge and args.low_memory:
        route = _low_memory_merge
    return route(run)


if __name__ == "__main__":
    sys.exit(main())
