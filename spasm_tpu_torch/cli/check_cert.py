"""Verify a rank certificate against a matrix (tools/check_cert.c).

Port of spasm_tpu/cli/check_cert.py, on the host.  Note: the reference
prints CORRECT/INCORRECT inverted and returns the wrong exit code
(check_cert.c:77-80); this implementation is correct (exit 0 on a
correct certificate), as flagged in SURVEY.md.
"""
from __future__ import annotations

import argparse
import sys

from ..certificate import certificate_load, rank_certificate_verify
from .common import add_input_args, load_input


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-check-cert", description="Verify a rank certificate")
    add_input_args(ap)
    ap.add_argument("--certificate", "-c", metavar="FILE", default=None,
                    help="Read the certificate from FILE (default stdin)")
    args = ap.parse_args(argv)
    A, h = load_input(args, want_hash=True)
    src = args.certificate if args.certificate is not None else sys.stdin
    proof = certificate_load(src)
    if proof is None:
        print("MALFORMED certificate", file=sys.stderr)
        return 2
    correct = rank_certificate_verify(A, h, proof)
    print("CORRECT certificate" if correct else "INCORRECT certificate",
          file=sys.stderr)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
