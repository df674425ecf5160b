"""bwt_convert: BWT format transcoder (reference bwt_convert.cpp:37-123).

Usage: python -m bwtmerge_tpu_torch.cli.bwt_convert [-i fmt] [-o fmt] input
       output [--rlo [--device cuda|cpu]]

Port of bwtmerge_tpu/cli/bwt_convert.py.  Defaults match the reference:
sga -> native.  Conversion routes through the in-memory RunArrays
representation on the host.  --rlo rebuilds the BWT with its reads in
reverse-lexicographic order (models/build.rlo_reorder); only that rebuild
may use --device, and only for collections of 2^20 positions or more.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..models.fmi import FMI, load_fmi, serialize_fmi
from ..utils.metrics import in_gigabytes, in_megabytes, memory_usage
from .common import check_format, print_formats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwt_convert",
        description="Convert a BWT file between formats.")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-i", dest="input_format", default="sga", metavar="FMT",
                   help="input format (default sga)")
    p.add_argument("-o", dest="output_format", default="native", metavar="FMT",
                   help="output format (default native)")
    p.add_argument("--rlo", action="store_true",
                   help="re-order the reads reverse-lexicographically while "
                        "converting (shrinks the run count; query-equivalent)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --rlo rebuild of a large "
                        "collection (default cuda)")
    p.add_argument("--list-formats", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_formats:
        print_formats(sys.stdout)
        return 0
    check_format(args.input_format, "bwt_convert", "input")
    check_format(args.output_format, "bwt_convert", "output")

    if not args.quiet:
        print("BWT converter (PyTorch)")
        print("")
        print(f"Input:   {args.input} ({args.input_format})")
        print(f"Output:  {args.output} ({args.output_format})")
        print("")

    start = time.monotonic()
    fmi = load_fmi(args.input, args.input_format)
    size = fmi.size()
    if args.rlo:
        from ..models.build import rlo_reorder

        before = fmi.runs.n_runs
        fmi = FMI.from_runs(rlo_reorder(fmi, device=args.device))
        if not args.quiet:
            print(f"RLO reorder: {before} -> {fmi.runs.n_runs} runs")
    serialize_fmi(fmi, args.output, args.output_format)
    seconds = time.monotonic() - start

    if not args.quiet:
        print(f"BWT converted in {seconds:.2f} seconds "
              f"({in_megabytes(size) / max(seconds, 1e-9):.2f} MB/s)")
        print("")
        print(f"Memory usage: {in_gigabytes(memory_usage()):.3f} GB")
        print("")
    return 0


if __name__ == "__main__":
    sys.exit(main())
