"""Preprocessor: drop empty rows and columns (tools/stack.c).

Port of spasm_tpu/cli/stack.py, on the host."""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import sio
from .common import add_input_args, load_input_triplet


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-stack",
        description="Remove empty rows/columns from a matrix")
    add_input_args(ap)
    args = ap.parse_args(argv)
    T, _ = load_input_triplet(args)
    print(f"matrix has advertized dimension {T.n} x {T.m}...",
          file=sys.stderr, end=" ")
    rmap = np.full(T.n, -1, np.int64)
    cmap = np.full(T.m, -1, np.int64)
    rused = np.unique(T.row)
    cused = np.unique(T.col)
    rmap[rused] = np.arange(rused.size)
    cmap[cused] = np.arange(cused.size)
    T.row = rmap[T.row].astype(np.int32)
    T.col = cmap[T.col].astype(np.int32)
    T.n, T.m = int(rused.size), int(cused.size)
    print(f"but is in fact {T.n} x {T.m}", file=sys.stderr)
    sio.save_triplet(T, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
