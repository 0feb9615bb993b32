"""Shared CLI plumbing: input/modulus options and echelonization flags.

Port of spasm_tpu/cli/common.py (the reference's argp parsers,
tools/common.c:12-110).  The finishers run on the card.
"""
from __future__ import annotations

import argparse
import sys

from .. import sio
from ..echelonize import EchelonizeOptions


def add_input_args(ap: argparse.ArgumentParser):
    g = ap.add_argument_group("Input problem")
    g.add_argument("--matrix", "-m", metavar="FILE", default=None,
                   help="Read the input matrix from FILE (default stdin)")
    g.add_argument("--modulus", "-p", metavar="P", type=int, default=42013,
                   help="Perform arithmetic modulo P, an odd prime <= "
                   "2^32 - 5 (default 42013)")


def add_echelonize_args(ap: argparse.ArgumentParser):
    g = ap.add_argument_group("Echelonization sub-algorithms")
    g.add_argument("--no-low-rank-mode", action="store_true",
                   help="Disable the (dense) low-rank mode")
    g.add_argument("--no-dense-mode", action="store_true",
                   help="Don't use the dense device kernels")
    g.add_argument("--no-GPLU", action="store_true",
                   help="Don't use GPLU")
    g.add_argument("--no-greedy-pivot-search", action="store_true",
                   help="Disable the greedy cycle-free pivot search")
    g = ap.add_argument_group("Main echelonization options")
    g.add_argument("--max-iterations", metavar="N", type=int, default=3,
                   help="Rounds of pivot search + sparse Schur complement")
    g.add_argument("--dense-threshold", metavar="D", type=float,
                   default=0.05,
                   help="Use dense elimination when density exceeds D")
    g.add_argument("--min-pivot-proportion", metavar="P", type=float,
                   default=0.1,
                   help="Stop when pivot proportion drops below P")
    g = ap.add_argument_group("Dense code options")
    g.add_argument("--dense-block-size", metavar="N", type=int, default=1000,
                   help="Use dense blocks of at least N rows")
    g.add_argument("--min-rank-ratio", metavar="R", type=float, default=0.5,
                   help="Low-rank mode when k rows have rank <= k*R")
    g.add_argument("--max-aspect-ratio", metavar="R", type=float,
                   default=5.0,
                   help="Low-rank mode when #rows/#cols >= R")
    g = ap.add_argument_group("Fault tolerance")
    g.add_argument("--checkpoint", metavar="FILE", default=None,
                   help="Snapshot engine state to FILE after every round "
                        "and dense block; resume from it if present")
    g = ap.add_argument_group("Observability")
    g.add_argument("--profile", metavar="DIR", default=None,
                   help="Capture a torch.profiler trace into DIR")


def opts_from_args(args) -> EchelonizeOptions:
    return EchelonizeOptions(
        enable_greedy_pivot_search=not getattr(
            args, "no_greedy_pivot_search", False),
        enable_tall_and_skinny=not args.no_low_rank_mode,
        enable_dense=not args.no_dense_mode,
        enable_GPLU=not args.no_GPLU,
        max_round=args.max_iterations,
        sparsity_threshold=args.dense_threshold,
        min_pivot_proportion=args.min_pivot_proportion,
        tall_and_skinny_ratio=args.max_aspect_ratio,
        dense_block_size=args.dense_block_size,
        low_rank_ratio=args.min_rank_ratio,
        checkpoint_file=getattr(args, "checkpoint", None),
    )


def load_input(args, want_hash: bool = False):
    src = args.matrix if args.matrix is not None else sys.stdin.buffer
    return sio.load_csr(src, args.modulus, want_hash=want_hash)


def load_input_triplet(args, want_hash: bool = False):
    src = args.matrix if args.matrix is not None else sys.stdin.buffer
    return sio.load_triplet(src, args.modulus, want_hash=want_hash)


def maybe_trace(args):
    """Context capturing a profiler trace when --profile was given."""
    from ..profiling import maybe_trace as _mt
    return _mt(getattr(args, "profile", None))


def open_output(filename):
    if filename is None:
        return sys.stdout, False
    return open(filename, "w"), True
