"""Dulmage-Mendelsohn decomposition tool (tools/dm.c).

Port of spasm_tpu/cli/dm.py, on the host.  -P/--permuted: permuted
matrix on stdout; -v/--verbose: block report + structural rank;
-t/--tabulated; -i/--image MPIX: color PNM image.
"""
from __future__ import annotations

import argparse
import math
import sys

from .. import sio
from ..csr import pinv as make_pinv
from ..dm import dulmage_mendelsohn
from .common import add_input_args, load_input


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-dm",
        description="Compute a Dulmage-Mendelsohn decomposition")
    add_input_args(ap)
    ap.add_argument("--permuted", "-P", action="store_true",
                    help="Output the permuted matrix (default)")
    ap.add_argument("--verbose", "-v", action="store_true",
                    help="Block structure report")
    ap.add_argument("--tabulated", "-t", action="store_true")
    ap.add_argument("--image", "-i", metavar="MPIX", type=float,
                    default=None, help="Color PNM image of given Mpixels")
    args = ap.parse_args(argv)

    A, _ = load_input(args)
    n, m = A.n, A.m
    DM = dulmage_mendelsohn(A)
    rr, cc = DM.rr, DM.cc
    B = A.permute(DM.p, make_pinv(DM.q, m))

    if args.verbose:
        print(f"structural rank = {int(rr[2] + cc[4] - cc[3])}")
        h_n, h_m = rr[1] - rr[0], cc[2] - cc[0]
        if h_n > 0 and h_m > 0:
            print(f"*) H ({h_n} x {h_m})")
        s_n, s_m = rr[2] - rr[1], cc[3] - cc[2]
        if s_n > 0 and s_m > 0:
            print(f"*) S ({s_n} x {s_m}) : ")
            n_trivial = 0
            for i in range(1, DM.nb - 1):
                size = DM.r[i + 1] - DM.r[i]
                if size == 1:
                    n_trivial += 1
                else:
                    print(f"    *) SCC of size {size}")
            if n_trivial > 0:
                print(f"    -> plus {n_trivial} SCC of size 1")
        v_n, v_m = rr[4] - rr[2], cc[4] - cc[3]
        if v_n > 0 and v_m > 0:
            print(f"*) V ({v_n} x {v_m})")
    elif args.tabulated:
        print(f"{n}\t{m}\t{A.nnz}\t{int(rr[2] + cc[4] - cc[3])}")
    elif args.image is not None:
        alpha = math.sqrt(args.image * 1e6 / max(n * m, 1))
        sio.save_pnm(B, sys.stdout, int(alpha * m), int(alpha * n), 3, DM)
    else:
        sio.save_csr(B, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
