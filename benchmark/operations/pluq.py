"""Operation `pluq`: a factorization, `echelonize` with the mix's options
(complete=True: A = L U with row permutation p), then the rank, qinv, p,
L and U read to the host, which is what a user who factors once and
solves pays.  The reference checks the rank, U's echelon form, L's
structure and A X = L (U X)."""
from benchmark import echelon

plant = echelon.plant


def call(prog, torch, A, opts, dev):
    return echelon.call(prog, torch, A, opts, dev, read_l=True)


def launch(prog, torch, A, opts, dev):
    echelon.launch(prog, torch, A, opts, dev)


def check(cell, inputs, kept, dev, torch):
    return echelon.check(cell, inputs, kept, dev, torch, lu=True)
