"""Operation `rank`: the rank tool's call, `echelonize` with the mix's
options, then the rank, qinv and U read to the host.  The reference
checks the rank, U's echelon form and that rowspan(A) lies in
rowspan(U)."""
from benchmark import echelon

plant = echelon.plant


def call(prog, torch, A, opts, dev):
    return echelon.call(prog, torch, A, opts, dev, read_l=False)


def launch(prog, torch, A, opts, dev):
    echelon.launch(prog, torch, A, opts, dev)


def check(cell, inputs, kept, dev, torch):
    return echelon.check(cell, inputs, kept, dev, torch, lu=False)
