"""bwt_inspect: identify BWT files by header (reference bwt_inspect.cpp:39-106).

Usage: python -m bwtmerge_tpu_torch.cli.bwt_inspect input1 [input2 ...]

Port of bwtmerge_tpu/cli/bwt_inspect.py, host-only over the port's own
formats/headers.py.  Tries NativeHeader, SGAHeader, RopeHeader in that
order; prints per-file identification and accumulated sequence/base totals
(Rope has no counts).
"""

from __future__ import annotations

import argparse
import sys

from ..formats.headers import NativeHeader, RopeHeader, SGAHeader


def identify(data: bytes):
    """Return (header, sequences, bases) or None. Mirrors inspect<Header>."""
    for cls in (NativeHeader, SGAHeader, RopeHeader):
        if len(data) < cls.SIZE:
            continue
        header = cls.from_bytes(data[: cls.SIZE])
        if header.check():
            seqs = getattr(header, "sequences", 0)
            bases = getattr(header, "bases", 0)
            return header, seqs, bases
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bwt_inspect",
                                description="Identify BWT files by header.")
    p.add_argument("files", nargs="+", metavar="FILE")
    args = p.parse_args(argv)

    print("Inspecting BWT files")
    print("")

    total_sequences = 0
    total_bases = 0
    for name in args.files:
        try:
            with open(name, "rb") as f:
                data = f.read(max(NativeHeader.SIZE, SGAHeader.SIZE))
        except OSError:
            print(f"bwt_inspect: Cannot open input file {name}", file=sys.stderr)
            continue
        res = identify(data)
        if res is None:
            print(f"{name}: Unknown format")
            continue
        header, seqs, bases = res
        total_sequences += seqs
        total_bases += bases
        print(f"{name}: {header}")
    print("")
    print(f"Total: {total_sequences} sequences, {total_bases} bases")
    print("")
    return 0


if __name__ == "__main__":
    sys.exit(main())
