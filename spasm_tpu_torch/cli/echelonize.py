"""Write U (or the RREF with --rref) of a matrix as SMS to stdout
(tools/echelonize.c).

Port of spasm_tpu/cli/echelonize.py; the finishers run on the card."""
from __future__ import annotations

import argparse
import sys

from .. import sio
from ..echelonize import echelonize
from ..rref import rref as compute_rref
from .common import (add_echelonize_args, add_input_args, load_input,
                     opts_from_args, maybe_trace)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-echelonize",
        description="Echelonize a sparse matrix; write U (SMS) to stdout")
    add_input_args(ap)
    add_echelonize_args(ap)
    ap.add_argument("--rref", action="store_true",
                    help="Output the RREF (of A*Q) instead of U")
    ap.add_argument("--low-rank-start-weight", type=int, default=-1)
    args = ap.parse_args(argv)
    A, _ = load_input(args)
    opts = opts_from_args(args)
    opts.low_rank_start_weight = args.low_rank_start_weight
    with maybe_trace(args):
        fact = echelonize(A, opts)
    if args.rref:
        R, _ = compute_rref(fact)
        sio.save_csr(R, sys.stdout)
    else:
        sio.save_csr(fact.U, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
