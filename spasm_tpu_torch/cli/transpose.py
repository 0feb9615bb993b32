"""Transpose filter (tools/transpose.c).

Port of spasm_tpu/cli/transpose.py, on the host."""
from __future__ import annotations

import argparse
import sys

from .. import sio
from .common import add_input_args, load_input


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spasm-transpose",
                                 description="Transpose a sparse matrix")
    add_input_args(ap)
    args = ap.parse_args(argv)
    A, _ = load_input(args)
    sio.save_csr(A.transpose(), sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
