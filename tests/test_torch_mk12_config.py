"""mk12.b4's benchmark configuration at small sizes: the port's
`echelonize(..., device="cpu")` on small matching complexes from the
benchmark's frozen generator, at SpaSM's default prime and at 2^32 - 5,
held to the plain reference exactly as the cells `mk12b4.rank` and
`mk12b4.rank.p4294967291` hold the card (`operations/rank_wide.py`:
rank_gap, echelon_faults and the wide span_residual, limit 0 each), on
the routes mk12.b4 takes: the rank finisher in rows mode from round 0,
and round 0's sparse Schur complement through the reduced basis (B1
wide's plain version at d = 4) before it.  The wide reference itself is
held to Python integers at 2^32 - 5 and to `reference.span_residual` at
42013."""
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import spasm_tpu_torch as prog
from benchmark import echelon, harness
from benchmark import reference as ref
from benchmark import reference_wide as wide

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CPU = torch.device("cpu")
P = 42013
PW = 4294967291                  # 2^32 - 5, d = 4
SEED = 2 ** 32 + 2 ** 31 + 7     # a seed beyond 32 bits
RANK_WIDE = harness.load_module(BENCH / "operations" / "rank_wide.py")
GEN = harness.load_module(BENCH / "matrices" / "matching_complex.py")

# name -> generate(n, j, transpose): the rank tool's orientation
MATRICES = {"mk7.b2": (7, 2, False), "mk8.b2": (8, 2, False),
            "mk9.b3": (9, 3, True), "mk10.b3": (10, 3, False)}
SMALLEST = ("mk7.b2", "mk8.b2")          # ranked in Python integers
# mk12.b4's routes at small size.  rows: the rank finisher in rows mode
# from round 0 (device_dense_min 0 lets a small block reach it).
# schur_rows: the width cap (device_dense_width, a quarter of it at
# d >= 3) between the free columns left by rounds 1 and 0, so round 0
# forms its sparse Schur complement through the reduced basis, as
# mk12.b4's does at 2^32 - 5, and round 1 hands the rank finisher the
# rest in rows mode.
ROUTES = {"default": lambda p: {},
          "rows": lambda p: {"device_dense_min": 0},
          "schur_rows": lambda p: {"device_dense_min": 0,
                                   "device_dense_width":
                                       600 * (4 if p > 65535 else 1)}}
CASES = ([(name, p, route) for name in MATRICES for p in (P, PW)
          for route in ("default", "rows")]
         + [("mk10.b3", p, "schur_rows") for p in (P, PW)])


def _matrix(name):
    """(n, m, indptr, indices, values) of the frozen generator."""
    return GEN.generate(*MATRICES[name])


def _dense(name) -> np.ndarray:
    n, m, indptr, indices, values = _matrix(name)
    D = np.zeros((n, m), np.int64)
    D[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    return D


def _rank_python(D: np.ndarray, p: int) -> int:
    """Rank mod p by Gaussian elimination in Python integers."""
    A = np.array(D, dtype=object) % p
    n, m = A.shape
    r = 0
    for j in range(m):
        piv = [i for i in range(r, n) if A[i, j]]
        if not piv:
            continue
        A[[r, piv[0]]] = A[[piv[0], r]]
        A[r] = A[r] * pow(int(A[r, j]), p - 2, p) % p
        below = A[r + 1:, j].copy()
        A[r + 1:] = (A[r + 1:] - np.outer(below, A[r])) % p
        r += 1
    return r


_RANKS = {}


def _reference_rank(name, p) -> int:
    """Python integers on the smallest matrices at either prime; on the
    rest the plain dense rank at 42013, which the smallest show equal to
    the rank at 2^32 - 5 (test_ranks_agree_across_primes)."""
    key = (name, p if name in SMALLEST else P)
    if key not in _RANKS:
        D = _dense(name)
        _RANKS[key] = (_rank_python(D, key[1]) if name in SMALLEST
                       else ref.dense_rank(torch.as_tensor(D), P))
    return _RANKS[key]


def _cell(name, p):
    return types.SimpleNamespace(prime=p, config={
        "ranks": {str(p): _reference_rank(name, p)}})


def _run(name, p, route, call=0):
    """One benchmark call on the CPU: the input of `call` under the
    seed's +-1 scalings, echelonize with the route's options, the
    answers read as the cells read them."""
    inputs = harness.Inputs(_matrix(name), p, SEED)
    opts = prog.EchelonizeOptions(**ROUTES[route](p))
    out, _ = echelon.call(prog, torch, inputs.csr(prog, call), opts, CPU,
                          read_l=False)
    return inputs, out


def _check(name, p, inputs, kept):
    return RANK_WIDE.check(_cell(name, p), inputs, kept, CPU, torch)


@pytest.mark.parametrize("name,p,route", CASES)
def test_port_against_reference(name, p, route, caplog):
    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        inputs, out = _run(name, p, route)
    got = _check(name, p, inputs, {0: out})
    assert got == [{"rank_gap": 0, "echelon_faults": 0,
                    "span_residual": 0}]
    assert out["r"] == _reference_rank(name, p)
    if route != "default" and out["r"] > out["rounds"][0]["pivots"]:
        assert "[finish/device] rows mode" in caplog.text
    if route == "schur_rows":
        assert "schur_nnz" in out["rounds"][0]
        assert out["rounds"][1]["pivots"] > 0
        assert "[finish/device] rows mode" in caplog.text


def test_ranks_agree_across_primes():
    for name in SMALLEST:
        D = _dense(name)
        r = _rank_python(D, P)
        assert r == _rank_python(D, PW) == ref.dense_rank(
            torch.as_tensor(D), P)
        assert 0 < r < min(D.shape)           # rank-deficient


@pytest.mark.parametrize("fault", ["drop", "alter", "stale"])
def test_faults_are_caught_at_the_wide_prime(fault):
    inputs, out = _run("mk9.b3", PW, "rows")
    if fault == "stale":                     # another call's answers
        _, out = _run("mk9.b3", PW, "rows", call=1)
    else:
        out = echelon.plant(out, fault, PW)
    got = _check("mk9.b3", PW, inputs, {0: out})[0]
    assert any(v > 0 for v in got.values()), got


def test_config_file_matches_the_generator():
    conf = json.loads((BENCH / "configs" / "mk12.b4.json").read_text())
    n, m, indptr, _, values = GEN.generate(**conf["args"])
    assert [n, m] == conf["shape"] == [62370, 51975]
    assert int(indptr[-1]) == conf["nnz"] == 311850
    assert set(np.unique(values)) == {-1, 1}
    assert conf["ranks"] == {str(P): 39535, str(PW): 39535}
    assert conf["reduced"] == []
    mix = json.loads((BENCH / "mixes" / "rank.p4294967291.json")
                     .read_text())
    assert (mix["operation"], mix["prime"], mix["options"]) == \
        ("rank_wide", PW, {})


# -- the wide reference ------------------------------------------------------

def _echelon(rng, r, m, p):
    """A random echelon basis U (r x m, unit pivots at increasing
    columns, entries in [0, p)) as (dense, qinv)."""
    piv = np.sort(rng.choice(m, r, replace=False))
    U = np.zeros((r, m), dtype=object)
    for i, c in enumerate(piv):
        U[i, c + 1:] = [int(x) for x in rng.integers(0, p, m - c - 1)]
        U[i, piv] = 0
        U[i, c] = 1
    qinv = np.full(m, -1, np.int64)
    qinv[piv] = np.arange(r)
    return U, qinv


def _csr(D):
    D = np.asarray(D, dtype=object)
    rows, cols = np.nonzero(D != 0)
    indptr = np.zeros(D.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=D.shape[0]), out=indptr[1:])
    return indptr, cols.astype(np.int32), np.array(
        [int(x) for x in D[rows, cols]], np.int64)


def _residual_python(U, qinv, A, Y, p) -> int:
    """The span check in Python integers: Y^T A reduced by U."""
    X = (np.asarray(Y, dtype=object).T.dot(np.asarray(A, dtype=object))) % p
    for c in np.nonzero(qinv >= 0)[0]:
        X = (X - np.outer(X[:, c], U[qinv[c]])) % p
    return int((X != 0).sum())


def _wide_case(seed, p, outside):
    rng = np.random.default_rng(seed)
    r, m, n = 6, 14, 9
    U, qinv = _echelon(rng, r, m, p)
    C = np.array([[int(x) for x in rng.integers(0, p, r)] for _ in range(n)],
                 dtype=object)
    A = C.dot(U) % p                          # rows inside rowspan(U)
    if outside:                               # + e_1: not in the span
        A[2, 1] = (A[2, 1] + 1) % p
    Y = rng.integers(0, p, (n, 2))
    E = ref.Echelon(*_csr(U), r, m, p, CPU)
    assert ref.echelon_faults(E, qinv) == 0
    return U, qinv, A, Y, E


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("outside", [False, True])
def test_wide_reference_exact_at_2_32_minus_5(seed, outside):
    U, qinv, A, Y, E = _wide_case(seed, PW, outside)
    want = _residual_python(U, qinv, A, Y, PW)
    assert (want > 0) == outside
    got = wide.span_residual(E, *_csr(A), torch.as_tensor(Y))
    assert got == want


def test_plain_reference_wraps_at_2_32_minus_5():
    """The reason for reference_wide: int64 products of residues near
    2^32 wrap, and a basis that spans A is reported with a residue."""
    U, qinv, A, Y, E = _wide_case(4, PW, False)
    assert wide.span_residual(E, *_csr(A), torch.as_tensor(Y)) == 0
    assert ref.span_residual(E, *_csr(A), torch.as_tensor(Y)) > 0


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("outside", [False, True])
def test_wide_reference_equals_plain_at_42013(seed, outside):
    U, qinv, A, Y, E = _wide_case(seed, P, outside)
    Yt = torch.as_tensor(Y)
    got = wide.span_residual(E, *_csr(A), Yt)
    assert got == ref.span_residual(E, *_csr(A), Yt) \
        == _residual_python(U, qinv, A, Y, P)


def test_mulmod_against_python_integers():
    rng = np.random.default_rng(9)
    a = rng.integers(0, PW, 4096)
    b = rng.integers(0, PW, 4096)
    a[:3], b[:3] = PW - 1, PW - 1
    got = wide.mulmod(torch.as_tensor(a), torch.as_tensor(b), PW)
    assert got.tolist() == [int(x) * int(y) % PW for x, y in zip(a, b)]
