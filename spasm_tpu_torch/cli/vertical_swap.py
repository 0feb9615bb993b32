"""Preprocessor: mirror the columns (tools/vertical_swap.c).

Port of spasm_tpu/cli/vertical_swap.py, on the host.  Flipping columns
helps the Faugere-Lachartre pivot search on matrices whose leftmost
columns are dense (SpaSM README.md:86-91).
"""
from __future__ import annotations

import argparse
import sys

from .. import sio
from .common import add_input_args, load_input_triplet


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-vertical-swap", description="Mirror matrix columns")
    add_input_args(ap)
    args = ap.parse_args(argv)
    T, _ = load_input_triplet(args)
    T.col = (T.m - T.col.astype(int) - 1).astype(T.col.dtype)
    sio.save_triplet(T, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
