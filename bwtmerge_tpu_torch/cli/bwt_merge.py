"""bwt_merge on a torch device — the two-input merge with -v verification.

Usage: python -m bwtmerge_tpu_torch.cli.bwt_merge [options] A B output

Port of the two-input path of bwtmerge_tpu/cli/bwt_merge.py.  B needs its
read-text sidecar (`B.reads4`): the port's search is the per-read walk.
Features of later port slices exit with status 1 and name their ROADMAP
item: more than two inputs and --fold kway, --checkpoint, --low-memory,
-t > 1, --index-placement sharded, --search trie, and a B without a usable
sidecar.  Exit status 2 means the -v pattern counts of the output differ
from the inputs' sum.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from bwtmerge_tpu.formats.streaming import STREAM_WRITERS
from bwtmerge_tpu.utils.metrics import in_megabytes

from ..kernels import resolve_device
from ..models.fmi import load_fmi, serialize_fmi
from ..models.merge import (MergeConfig, WalkUnavailableError, merge_fmi,
                            merge_fmi_to_file)
from .common import check_format, read_rows, report_totals, verify_fmi


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwt_merge", add_help=True,
        description="Merge two BWTs of DNA read collections on a torch "
                    "device.",
        epilog="Formats: native, plain_default, plain_sorted, rfm, sdsl, "
               "ropebwt, sga")
    p.add_argument("files", nargs="+", metavar="FILE",
                   help="input1 input2 output")
    p.add_argument("-d", dest="temp_dir", default=".", metavar="DIR",
                   help="temp directory (default .)")
    p.add_argument("-v", dest="patterns", default=None, metavar="FILE",
                   help="verify pattern counts before/after the merge")
    p.add_argument("-i", dest="input_formats", default=None,
                   metavar="FMT[,FMT]",
                   help="input format(s), comma separated (default native)")
    p.add_argument("-o", dest="output_format", default="native", metavar="FMT",
                   help="output format (default native)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--device-blocks", dest="device_blocks", type=int,
                   default=None, metavar="N",
                   help="read blocks walked as separate launches: block k's "
                        "rank-array copy overlaps block k+1's walk "
                        "(default: auto)")
    p.add_argument("--search", default="auto",
                   choices=("auto", "walk", "trie"),
                   help="search engine: the per-read walk (needs B's "
                        "read-text sidecar); trie is a later slice")
    p.add_argument("--hash", action="store_true", dest="print_hash",
                   help="print the FNV-1a content hash of the merged BWT")
    p.add_argument("--stream", action="store_true",
                   help="stream the merged BWT straight to the output file "
                        "(native/sga only)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress output")
    # later slices: accepted so that they can be refused by name
    p.add_argument("-t", dest="devices", type=int, default=None, metavar="N",
                   help=argparse.SUPPRESS)
    p.add_argument("--index-placement", dest="index_placement",
                   default="auto", choices=("auto", "replicated", "sharded"),
                   help=argparse.SUPPRESS)
    p.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    p.add_argument("--low-memory", action="store_true", dest="low_memory",
                   help=argparse.SUPPRESS)
    p.add_argument("--fold", default="auto", choices=("auto", "kway", "chain"),
                   help=argparse.SUPPRESS)
    return p


def _later_slice(args, n_inputs: int):
    """The ROADMAP item a requested feature waits for, or None."""
    if n_inputs > 2 or args.fold == "kway":
        return "more than two inputs / --fold kway: ROADMAP A.6 (slice 2)"
    if args.checkpoint or args.low_memory:
        return "--checkpoint / --low-memory: ROADMAP A.6 (slice 2)"
    if args.search == "trie":
        return "--search trie: ROADMAP A.7 (slice 3)"
    if (args.devices or 1) > 1 or args.index_placement == "sharded":
        return "-t > 1 / --index-placement sharded: ROADMAP A.10 (slice 5)"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.files) < 3:
        print("bwt_merge: need two inputs and an output", file=sys.stderr)
        return 1
    inputs, output = args.files[:-1], args.files[-1]
    later = _later_slice(args, len(inputs))
    if later:
        print(f"bwt_merge: not in this port yet: {later}", file=sys.stderr)
        return 1

    start = time.monotonic()
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
                         verbose=not args.quiet, search=args.search)
    if args.device_blocks is not None:
        config.device_blocks = args.device_blocks
    config.sanitize()

    if not args.quiet:
        print("BWT-merge (PyTorch)")
        print("")
        for name, fmt in zip(inputs, in_formats):
            print(f"Input:            {name} ({fmt})")
        print(f"Output:           {output} ({args.output_format})")
        if args.patterns:
            print(f"Patterns:         {args.patterns}")
        print(f"Device:           {device}")
        print("")

    patterns = read_rows(args.patterns) if args.patterns else []
    pre = np.zeros(len(patterns), dtype=np.int64)
    post = np.zeros(len(patterns), dtype=np.int64)
    if patterns and not args.quiet:
        chars = sum(len(p) for p in patterns)
        print(f"Read {len(patterns)} patterns of total length {chars}")
        print("")

    stream = args.stream and args.output_format in STREAM_WRITERS
    if args.stream and not stream:
        print(f"Warning: --stream ignored (output format "
              f"'{args.output_format}' has no streaming writer); merging "
              "fully in memory", file=sys.stderr)

    index = load_fmi(inputs[0], in_formats[0])
    verify_fmi(index, "Input", patterns, pre, verbose=not args.quiet,
               device=device)
    increment = load_fmi(inputs[1], in_formats[1])
    verify_fmi(increment, "Input", patterns, pre, verbose=not args.quiet,
               device=device)

    merge_start = time.monotonic()
    try:
        if stream:
            merge_fmi_to_file(index, increment, output, args.output_format,
                              config)
        else:
            index = merge_fmi(index, increment, config)
    except WalkUnavailableError as e:
        print(f"bwt_merge: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        secs = time.monotonic() - merge_start
        print(f"Merged {inputs[1]}: "
              f"{in_megabytes(increment.size()) / max(secs, 1e-9):.2f} MB/s")

    if stream:
        if patterns or args.print_hash:
            index = load_fmi(output, args.output_format)
            verify_fmi(index, "Output", patterns, post,
                       verbose=not args.quiet, device=device)
    else:
        serialize_fmi(index, output, args.output_format)
        verify_fmi(index, "Output", patterns, post, verbose=not args.quiet,
                   device=device)

    if args.print_hash:
        print(f"Hash:             {index.hash():016x}")

    status = 0
    if patterns:
        errors = int(np.sum(pre != post))
        if errors:
            print(f"Verification failed for {errors} patterns")
            status = 2
        else:
            print("Verification successful")
        print("")

    if not args.quiet:
        report_totals(time.monotonic() - start, increment.size())
    return status


if __name__ == "__main__":
    sys.exit(main())
