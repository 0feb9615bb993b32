"""The port's `dense` exports (modp_matmul, dnorm, device_field,
dense_rref, dense_lu), `modp.modp_matmul_np` and `profiling.start_trace` /
`stop_trace`: the twin of tests/test_dense.py on the CPU (`device="cpu"`,
B4 through its plain version) at conftest's six moduli, each result also
bit-equal to the JAX package's on the same numpy-made inputs (tolerance
0), and the signatures of the new names against the JAX package's."""
import inspect
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spasm_tpu.dense as jdense
from spasm_tpu.dense import modp as jmodp
from spasm_tpu import profiling as jprof

import spasm_tpu_torch.dense as tdense
from spasm_tpu_torch.dense import modp as tmodp
from spasm_tpu_torch import profiling as tprof
from spasm_tpu_torch.field import Field
from tests.conftest import ALL_MODULI, MATRIX
from tests.test_dense import np_rank, random_matrix

torch.set_num_threads(2)

NEW_NAMES = [(jdense, tdense, "modp_matmul"), (jdense, tdense, "dnorm"),
             (jdense, tdense, "device_field"), (jdense, tdense, "dense_rref"),
             (jdense, tdense, "dense_lu"),
             (jmodp, tmodp, "modp_matmul_np"),
             (jprof, tprof, "start_trace"), (jprof, tprof, "stop_trace")]


@pytest.mark.parametrize("jmod,tmod,name", NEW_NAMES,
                         ids=[n for _, _, n in NEW_NAMES])
def test_dense_exports_with_jax_signatures(jmod, tmod, name):
    """Each name exists in the port's matching module with the JAX
    package's signature, apart from a trailing `device=`."""
    js = inspect.signature(getattr(jmod, name))
    ts = inspect.signature(getattr(tmod, name))
    tparams = list(ts.parameters.values())
    if tparams and tparams[-1].name == "device":
        assert tparams[-1].default == "cuda"
        tparams = tparams[:-1]
    assert tparams == list(js.parameters.values())
    assert ts.return_annotation == js.return_annotation


def test_dense_exports_import_without_jax():
    code = ("import sys; from spasm_tpu_torch.dense import modp_matmul, "
            "dnorm, device_field, dense_rref, dense_lu; "
            "from spasm_tpu_torch.dense.modp import modp_matmul_np; "
            "from spasm_tpu_torch.profiling import start_trace, stop_trace; "
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "or m == 'spasm_tpu' or m.startswith('spasm_tpu.') "
            "for m in sys.modules) else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=MATRIX.parents[1],
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()


@pytest.mark.parametrize("p", ALL_MODULI)
def test_modp_matmul(p):
    rng = np.random.default_rng(42)
    F = Field(p)
    A = F.narray(rng.integers(0, p, size=(33, 57)))
    B = F.narray(rng.integers(0, p, size=(57, 29)))
    got = tdense.modp_matmul(A, B, p, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = F.narray((A.astype(object) @ B.astype(object)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jdense.modp_matmul(A, B,
                                                                      p)))
    np_out = tmodp.modp_matmul_np(A, B, p, device="cpu")
    assert isinstance(np_out, np.ndarray)
    assert np.array_equal(np_out, want)


def test_modp_matmul_deep_contraction():
    p = 4294967291
    rng = np.random.default_rng(1)
    F = Field(p)
    k = 70000          # crosses the k-chunk boundary (2^14 at d = 4)
    A = F.narray(rng.integers(0, p, size=(4, k)))
    B = F.narray(rng.integers(0, p, size=(k, 3)))
    got = tdense.modp_matmul(A, B, p, device="cpu").numpy()
    want = F.narray(A.astype(object) @ B.astype(object))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jdense.modp_matmul(A, B, p)))


def test_modp_matmul_takes_tensors_and_raises_without_cuda(monkeypatch):
    """Tensors stay tensors on the device asked for; device "cuda" (the
    default) without a card raises instead of running on the host."""
    p = 42013
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.integers(-(p // 2), p // 2 + 1, (8, 16),
                                      dtype=np.int32))
    got = tdense.modp_matmul(A, A.T.contiguous(), p, device="cpu")
    want = tmodp.matmul_digits(A, A.T.contiguous(), p)
    assert torch.equal(got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdense.modp_matmul(A, A, p)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodp.modp_matmul_np(A.numpy(), A.numpy(), p)


def _balanced(x: np.ndarray, p: int) -> np.ndarray:
    r = np.array([int(v) % p for v in x], dtype=object)
    return np.where(r > p // 2, r - p, r).astype(np.int64)


@pytest.mark.parametrize("p", ALL_MODULI)
def test_dnorm_matches_jax(p):
    """Across +-2^62 the port's dnorm is the exact balanced residue, and
    equal to the JAX package's with 3 Barrett rounds (2 are not exact there
    for p <= 257); at the default 2 rounds, equal inside the JAX domain
    |x| <= p * 2^30."""
    rng = np.random.default_rng(p)
    wide = np.concatenate([rng.integers(-2**62, 2**62, 4000, dtype=np.int64),
                           np.array([2**62, -2**62, 0, 1, -1, p, -p,
                                     p // 2, -(p // 2), p // 2 + 1],
                                    dtype=np.int64)])
    got = tdense.dnorm(torch.from_numpy(wide), p)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), _balanced(wide, p))
    assert np.array_equal(got.numpy(),
                          np.asarray(jdense.dnorm(jnp.asarray(wide), p, 3)))
    lim = p * 2**30
    near = rng.integers(-lim, lim + 1, 4000, dtype=np.int64)
    assert np.array_equal(tdense.dnorm(torch.from_numpy(near), p).numpy(),
                          np.asarray(jdense.dnorm(jnp.asarray(near), p)))


def test_device_field_matches_jax():
    for p in ALL_MODULI + [42013, 65279]:
        a, b = tdense.device_field(p), jdense.device_field(p)
        assert (a.p, a.ndigits) == (b.p, b.ndigits)
        assert np.array_equal(a.weights, b.weights)


@pytest.mark.parametrize("p", ALL_MODULI)
@pytest.mark.parametrize("shape,rank", [((20, 30), None), ((30, 20), None),
                                        ((25, 25), 10), ((40, 15), 7),
                                        ((15, 40), 5)])
def test_dense_rref_properties(p, shape, rank):
    n, m = shape
    S = random_matrix(n, m, p, rank, seed=n * m + p % 97)
    F = Field(p)
    R, pivcols = tdense.dense_rref(S, p, force="device", device="cpu")
    Rh, pivcolsh = tdense.dense_rref(S, p, force="host", device="cpu")
    assert np.array_equal(R, Rh) and np.array_equal(pivcols, pivcolsh)
    Rj, pivcolsj = jdense.dense_rref(S, p, force="device")
    assert np.array_equal(R, Rj) and np.array_equal(pivcols, pivcolsj)
    r = len(pivcols)
    assert r == np_rank(S, p)
    if r == 0:
        return
    P = R[:, pivcols]
    assert np.array_equal(P, np.eye(r, dtype=np.int32))
    resid = F.narray(S.astype(object) - S[:, pivcols].astype(object)
                     @ R.astype(object))
    assert not np.any(resid)


@pytest.mark.parametrize("p", ALL_MODULI)
@pytest.mark.parametrize("shape,rank", [((20, 30), None), ((30, 20), 12),
                                        ((25, 25), 25), ((16, 16), 3)])
def test_dense_lu_properties(p, shape, rank):
    n, m = shape
    S = random_matrix(n, m, p, rank, seed=n + m + p % 89)
    F = Field(p)
    r, prows, pivcols, L, U = tdense.dense_lu(S, p, force="device",
                                              device="cpu")
    rh, prowsh, pivcolsh, Lh, Uh = tdense.dense_lu(S, p, force="host",
                                                   device="cpu")
    assert (r, list(prows), list(pivcols)) == (rh, list(prowsh),
                                               list(pivcolsh))
    assert np.array_equal(L, Lh) and np.array_equal(U, Uh)
    rj, prowsj, pivcolsj, Lj, Uj = jdense.dense_lu(S, p, force="device")
    assert (r, list(prows), list(pivcols)) == (rj, list(prowsj),
                                               list(pivcolsj))
    assert np.array_equal(L, np.asarray(Lj))
    assert np.array_equal(U, np.asarray(Uj))
    assert r == np_rank(S, p)
    if r:
        assert np.array_equal(U[np.arange(r), pivcols], np.ones(r, np.int32))
        assert not np.any(np.triu(L[prows], 1))
    prod = F.narray(L.astype(object) @ U.astype(object)) if r else \
        np.zeros_like(S)
    assert np.array_equal(prod, S)


def test_dense_rank_edge_cases():
    from spasm_tpu_torch.dense.elim import dense_rank
    p = 257
    assert dense_rank(np.zeros((5, 8), np.int32), p, force="device",
                      device="cpu") == 0
    assert dense_rank(np.eye(6, dtype=np.int32), p, device="cpu") == 6
    one = np.zeros((3, 3), np.int32)
    one[2, 2] = 5
    assert dense_rank(one, p, device="cpu") == 1


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_start_stop_trace_write_a_trace(tmp_path):
    """start_trace / stop_trace capture a trace of the calls between them
    into trace_dir/trace.json (the same file `maybe_trace` and the tools'
    --profile write); stop_trace without a start does nothing."""
    tprof.stop_trace()
    assert not any(tmp_path.iterdir())
    A = torch.ones((32, 64), dtype=torch.int32)
    out = tmp_path / "trace"
    tprof.start_trace(str(out))
    with tprof.phase("modp_matmul"):
        tdense.modp_matmul(A, A.T.contiguous(), 42013, device="cpu")
    tprof.stop_trace()
    names = {e.get("name") for e in _events(out / "trace.json")}
    assert "spasm/modp_matmul" in names
    tprof.stop_trace()                   # a second stop: a no-op
    with tprof.maybe_trace(str(tmp_path / "ctx")):
        with tprof.phase("inside"):
            pass
    assert "spasm/inside" in {e.get("name") for e in
                              _events(tmp_path / "ctx" / "trace.json")}
    assert tprof._profiler is None
