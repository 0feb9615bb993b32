"""Trefethen_20000b's benchmark configuration at small sizes: the port's
complete PLUQ (`echelonize(..., complete=True, device="cpu")`) of
Trefethen minors from the benchmark's frozen generator, under the
harness's seeded +-1 row and column scalings, at 65537 (d = 3) and
2^32 - 5 (d = 4), held to the plain reference exactly as the cell
`trefethen20kb.pluq.p4294967291` holds the card (`operations/
pluq_wide.py`: rank_gap, echelon_faults, l_faults and the wide
lu_residual, limit 0 each) and bit-equal to the JAX package's complete
PLUQ.  Trefethen_600's minor sends a 311 x 311 block to the dense LU,
whose panels take `panel_steps` at these primes; the smaller ones
finish on the host.  The wide reference itself is held to Python
integers at 2^32 - 5, where the int64 `reference.lu_residual` wraps."""
import functools
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import echelonize as jechelonize
from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.field import Field as JField

import spasm_tpu_torch as prog
from benchmark import echelon, harness
from benchmark import reference as ref
from benchmark import reference_wide_lu as wide
from tests.test_torch_finish import _same_csr
from tests.test_torch_mk12_config import _csr, _rank_python

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CPU = torch.device("cpu")
PW = 4294967291                  # 2^32 - 5, d = 4
P3 = 65537                       # d = 3
SEED = 2 ** 32 + 2 ** 31 + 11    # a seed beyond 32 bits
PLUQ_WIDE = harness.load_module(BENCH / "operations" / "pluq_wide.py")
MINOR = harness.load_module(BENCH / "matrices" / "trefethen_minor.py")
FULL = harness.load_module(BENCH / "matrices" / "trefethen.py")
SIZES = (64, 300, 600)           # generate(n): (n - 1) x (n - 1)
CASES = [(n, p) for n in SIZES for p in (P3, PW)]


def _dense(gen) -> np.ndarray:
    n, m, indptr, indices, values = gen
    D = np.zeros((n, m), np.int64)
    D[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    return D


@functools.lru_cache(maxsize=None)
def _reference_rank(n, p) -> int:
    """Python integers up to Trefethen_300's minor; above, the wide
    reference's exact elimination (held to Python integers below)."""
    D = _dense(MINOR.generate(n))
    if n <= 300:
        return _rank_python(D, p)
    return wide.dense_rank(torch.as_tensor(D), p)


@functools.lru_cache(maxsize=None)
def _factor(n, p):
    """Call 0 of the cell's harness at (n, p) on the CPU: its input
    under the seed's scalings, the complete PLUQ with the answers read
    as the cell reads them, and the JAX package's complete PLUQ of the
    same input."""
    inputs = harness.Inputs(MINOR.generate(n), p, SEED)
    opts = prog.EchelonizeOptions(complete=True)
    A = inputs.csr(prog, 0)
    out, _ = echelon.call(prog, torch, A, opts, CPU, read_l=True)
    t = prog.echelonize(A, opts, device="cpu")
    J = JCSR(A.n, A.m, JField(p), A.indptr, A.indices, A.data)
    return inputs, out, t, jechelonize(J, JOpts(complete=True))


def _cell(n, p):
    return types.SimpleNamespace(prime=p, config={
        "ranks": {str(p): _reference_rank(n, p)}})


@pytest.mark.parametrize("n,p", CASES)
def test_port_against_reference(n, p):
    inputs, out, _, _ = _factor(n, p)
    got = PLUQ_WIDE.check(_cell(n, p), inputs, {0: out}, CPU, torch)
    assert got == [{"rank_gap": 0, "echelon_faults": 0, "l_faults": 0,
                    "lu_residual": 0}]
    assert out["r"] == _reference_rank(n, p) == n - 1


@pytest.mark.parametrize("n,p", CASES)
def test_complete_pluq_matches_jax(n, p):
    _, _, t, j = _factor(n, p)
    assert t.r == j.r and t.complete == j.complete
    assert np.array_equal(t.qinv, j.qinv) and np.array_equal(t.p, j.p)
    _same_csr(j.U, t.U)
    _same_csr(j.L, t.L)


def test_the_largest_minor_takes_panel_steps(monkeypatch):
    """Trefethen_600's minor reaches the dense LU's panels at d >= 3
    (one `panel_steps` a panel of the padded 512 columns); the smaller
    minors finish on the host."""
    from spasm_tpu_torch.dense import elim
    seen = []
    real = elim.panel_steps

    def count(*a, **kw):
        seen.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(elim, "panel_steps", count)
    for n in SIZES:
        seen.clear()
        inputs = harness.Inputs(MINOR.generate(n), PW, SEED)
        fact = prog.echelonize(inputs.csr(prog, 1),
                               prog.EchelonizeOptions(complete=True),
                               device="cpu")
        assert fact.r == n - 1
        assert seen == ([PW] * 8 if n == 600 else []), n


def test_exact_ranks_agree():
    for n in (64, 300):
        D = torch.as_tensor(_dense(MINOR.generate(n)))
        for p in (P3, PW):
            assert wide.dense_rank(D, p) == _reference_rank(n, p) == n - 1
    # a rank-deficient product at 2^32 - 5, residues near p
    rng = np.random.default_rng(4)
    C = np.array([[PW - 1 - int(x) for x in rng.integers(0, 9, 5)]
                  for _ in range(12)], dtype=object)
    B = np.array([[PW - 1 - int(x) for x in rng.integers(0, 9, 15)]
                  for _ in range(5)], dtype=object)
    D = C.dot(B) % PW
    assert wide.dense_rank(torch.as_tensor(D.astype(np.int64)), PW) == \
        _rank_python(D, PW) == 5


# -- the generator -----------------------------------------------------------

def test_generator_is_the_minor():
    for n in (20, 600):
        n1, m1, indptr, _, _ = gen = MINOR.generate(n)
        assert (n1, m1) == (n - 1, n - 1)
        assert np.array_equal(_dense(gen), _dense(FULL.generate(n))[1:, 1:])
        assert gen[3].dtype == np.int32 and indptr.dtype == np.int64
    assert int(MINOR.generate(20)[2][-1]) == 147        # Trefethen_20b
    assert int(MINOR.generate(20000)[2][-1]) == 554435  # Trefethen_20000b
    conf = json.loads((BENCH / "configs" / "trefethen_20000b.json")
                      .read_text())
    assert (conf["shape"], conf["nnz"]) == ([19999, 19999], 554435)


# -- the wide reference ------------------------------------------------------

def _near_p(rng, shape, p):
    """Residues in [p - 2^12, p): every product of two passes 2^63."""
    return p - 1 - rng.integers(0, 1 << 12, shape)


def _lu_case(seed, fault=None):
    """A = L U mod p in Python integers (L 9 x 4, U 4 x 11, X 11 x 2,
    entries near p), then one entry of L or of U moved by one."""
    rng = np.random.default_rng(seed)
    L = np.array(_near_p(rng, (9, 4), PW), dtype=object)
    U = np.array(_near_p(rng, (4, 11), PW), dtype=object)
    X = _near_p(rng, (11, 2), PW)
    A = L.dot(U) % PW
    if fault == "L":
        L[3, 2] = (L[3, 2] + 1) % PW
    elif fault == "U":
        U[1, 7] = (U[1, 7] + 1) % PW
    want = A.dot(np.asarray(X, dtype=object)) % PW != \
        L.dot(U.dot(np.asarray(X, dtype=object)) % PW) % PW
    return _csr(A), _csr(L), _csr(U), torch.as_tensor(X), int(want.sum())


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("fault", [None, "L", "U"])
def test_wide_lu_residual_exact_at_2_32_minus_5(seed, fault):
    A, L, U, X, want = _lu_case(seed, fault)
    assert (want > 0) == (fault is not None)
    assert wide.lu_residual(A, L, U, X, PW) == want


def test_plain_lu_residual_wraps_at_2_32_minus_5():
    """The reason for reference_wide_lu: int64 products of residues near
    2^32 wrap, and a correct factorization is reported with a residue."""
    A, L, U, X, want = _lu_case(4)
    assert want == 0 == wide.lu_residual(A, L, U, X, PW)
    assert ref.lu_residual(A, L, U, X, PW) > 0


@pytest.mark.parametrize("fault", [None, "L", "U"])
def test_wide_lu_residual_equals_plain_at_42013(fault):
    rng = np.random.default_rng(6)
    p = 42013
    L = rng.integers(0, p, (9, 4))
    U = rng.integers(0, p, (4, 11))
    X = torch.as_tensor(rng.integers(0, p, (11, 2)))
    A = L @ U % p
    if fault == "L":
        L[3, 2] = (L[3, 2] + 1) % p
    elif fault == "U":
        U[1, 7] = (U[1, 7] + 1) % p
    trip = [_csr(M) for M in (A, L, U)]
    got = wide.lu_residual(*trip, X, p)
    assert got == ref.lu_residual(*trip, X, p)
    assert (got > 0) == (fault is not None)
