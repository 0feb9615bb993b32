"""Compute the rank of a sparse matrix (tools/rank.c).

Port of spasm_tpu/cli/rank.py: auto-transposes wide matrices (n < m)
unless --no-transpose; with --certificate, produces and self-checks an
Eberly rank certificate.  The finishers run on the card.  Usage:

    python -m spasm_tpu_torch.cli.rank --modulus 42013 < matrix.sms
    python -m spasm_tpu_torch.cli.rank -c -o cert.txt < matrix.sms
"""
from __future__ import annotations

import argparse
import sys
import time

from ..certificate import (certificate_save, factorization_verify,
                           rank_certificate_create, rank_certificate_verify)
from ..echelonize import echelonize
from .common import (add_echelonize_args, add_input_args,
                     load_input_triplet, maybe_trace, opts_from_args)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-rank", description="Compute the rank of a sparse matrix")
    add_input_args(ap)
    add_echelonize_args(ap)
    g = ap.add_argument_group("Rank options")
    g.add_argument("--no-transpose", "-t", action="store_true",
                   help="Do not transpose the input matrix")
    g.add_argument("--certificate", "-c", action="store_true",
                   help="Output a rank certificate")
    g.add_argument("--output", "-o", metavar="FILE", default=None,
                   help="Write the rank certificate in FILE")
    args = ap.parse_args(argv)

    T, h = load_input_triplet(args, want_hash=True)
    if not args.no_transpose and T.n < T.m:
        print("[rank] transposing matrix", file=sys.stderr)
        T.transpose_inplace()
    A = T.tocsr()
    print(f"start. A is {A.n} x {A.m} ({A.nnz} nnz)", file=sys.stderr)

    opts = opts_from_args(args)
    if args.certificate:
        opts.L = True
    t0 = time.time()
    with maybe_trace(args):
        fact = echelonize(A, opts)
    print(f"done in {time.time() - t0:.3f} s rank = {fact.r}",
          file=sys.stderr)
    print(fact.r)

    if args.certificate:
        for seed in (42, 1337, 21011984):
            assert factorization_verify(A, fact, seed)
        print("generating certificate", file=sys.stderr)
        proof = rank_certificate_create(A, h, fact)
        correct = rank_certificate_verify(A, h, proof)
        print("CORRECT certificate" if correct else "INCORRECT certificate",
              file=sys.stderr)
        if args.output:
            print(f"Saving certificate to {args.output}", file=sys.stderr)
            certificate_save(proof, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
