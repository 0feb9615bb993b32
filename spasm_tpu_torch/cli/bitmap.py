"""PBM/PGM density image of the pattern (tools/bitmap.c).

Port of spasm_tpu/cli/bitmap.py, on the host."""
from __future__ import annotations

import argparse
import math
import sys

from .. import sio
from .common import add_input_args


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-bitmap",
        description="Generate a PBM/PGM image of the matrix pattern")
    add_input_args(ap)
    ap.add_argument("--gray", "-g", action="store_true",
                    help="PGM gray levels instead of B/W bitmap")
    ap.add_argument("--width", "-W", type=int, default=-1)
    ap.add_argument("--height", "-H", type=int, default=-1)
    ap.add_argument("--mpixels", "-M", type=float, default=-1)
    args = ap.parse_args(argv)

    src = args.matrix if args.matrix is not None else sys.stdin.buffer
    A, _ = sio.load_csr(src, -1)          # pattern only
    n, m = A.n, A.m
    w, h, mpix = args.width, args.height, args.mpixels
    if mpix > 0 and (w > 0 or h > 0):
        print("--mpixels and --width/--height are mutually exclusive",
              file=sys.stderr)
        return 1
    if mpix < 0 and w < 0 and h < 0:
        mpix = 1
    if mpix > 0:
        alpha = math.sqrt(mpix * 1e6 / max(n * m, 1))
        w, h = int(alpha * m), int(alpha * n)
        print(f"[bitmap] targeting {mpix:.1f} Mpixels ; w={w}, h={h}",
              file=sys.stderr)
    if w < 0 < h:
        w = m * h // max(n, 1)
    if h < 0 < w:
        h = n * w // max(m, 1)
    sio.save_pnm(A, sys.stdout, min(w, m), min(h, n),
                 2 if args.gray else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
