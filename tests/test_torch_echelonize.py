"""The slice end to end: the port's `echelonize` (structural pivots + the
device finisher, run on the CPU through the kernels' plain versions)
against the JAX package on the same inputs.  Tolerance 0: ranks, pivot
maps and U rows are exact.

Primes: 65269 stands for the top of the d = 2 tier, whose bound 65279 =
29 * 2251 is not prime (rank over it is undefined); WIDE are both ends
of d = 3 (65521 still stored int16, 65537 the first int32 prime) and
two of d = 4 (67108859 of the reference's grid, 2^32 - 5).  Above 65535
the JAX device finisher stores its basis in int16 and wraps (ROADMAP
C1): where it would engage, the oracle is the JAX host path."""
import functools

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import sio as jsio
from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.gen import matching_complex_boundary as jmcb

from spasm_tpu_torch import CSR, EchelonizeOptions, echelonize, sio
from spasm_tpu_torch import checkpoint as ckpt
from spasm_tpu_torch.cli import rank as rank_cli
from spasm_tpu_torch.gen import matching_complex_boundary as mcb
from spasm_tpu_torch.triangular import sparse_triangular_solve
from tests.conftest import ALL_TEST_MATRICES, MATRIX

torch.set_num_threads(2)

PRIMES = [3, 257, 42013, 65269]
WIDE = [65521, 65537, 67108859, 4294967291]
DEVICE_MIN0 = dict(device_dense_min=0)


@pytest.mark.parametrize("p", PRIMES + WIDE)
@pytest.mark.parametrize("name", ALL_TEST_MATRICES)
def test_rank_matches_jax_host_path(name, p):
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    want = jechelonize(J, JOpts(enable_dense=False)).r
    fact = echelonize(A, EchelonizeOptions(**DEVICE_MIN0), device="cpu")
    assert fact.r == want


@pytest.mark.parametrize("p", PRIMES + WIDE)
@pytest.mark.parametrize("name", ALL_TEST_MATRICES + ["trefethen_2000.sms"])
def test_default_options_match_jax(name, p):
    """Default options: the round loop (sparse Schur rounds included)
    and whichever finisher the JAX package picks."""
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    _same_factor(jechelonize(J), echelonize(A, device="cpu"))


def _mk10():
    """matching_complex_boundary(10, 3) as the rank tool orients it,
    4725 x 3150: round 0 leaves a sparse Schur complement (71608 nnz),
    round 1 too few pivots, and GPLU finishes."""
    J, A = jmcb(10, 3), mcb(10, 3)
    if A.n < A.m:
        J, A = J.transpose(), A.transpose()
    return J, A


@pytest.mark.parametrize("opts", [dict(device_dense_width=0), dict(),
                                  dict(max_round=1), dict(max_round=2),
                                  dict(max_round=1, device_dense_width=0),
                                  dict(enable_dense=False)])
def test_mk10_rounds_match_jax(opts, caplog):
    J, A = _mk10()
    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        t = echelonize(A, EchelonizeOptions(**opts), device="cpu")
    _same_factor(jechelonize(J, JOpts(**opts)), t)
    assert t.r == 2564
    assert len(t.rounds) == min(opts.get("max_round", 3), 2)
    assert t.rounds[0]["pivots"] == 2513
    if len(t.rounds) == 2:
        assert t.rounds[0]["schur_nnz"] == 71608
        assert t.rounds[1]["pivots"] == 48 and "[GPLU] done" in caplog.text


@pytest.mark.parametrize("max_round", [1, 2])
@pytest.mark.parametrize("name", ["BIOMD0000000424.int.mpl.sms", "dm.sms",
                                  "p3.sms", "trefethen_500.sms",
                                  "mat364.sms", "g1.sms"])
def test_max_round_matches_jax(name, max_round):
    J, _ = jsio.load_csr(MATRIX / name, 42013)
    A, _ = sio.load_csr(MATRIX / name, 42013)
    _same_factor(jechelonize(J, JOpts(max_round=max_round)),
                 echelonize(A, EchelonizeOptions(max_round=max_round),
                            device="cpu"))


def _same_factor(j, t):
    assert t.r == j.r
    assert np.array_equal(t.qinv, j.qinv)
    Uj, Ut = j.U, t.U
    assert (Ut.n, Ut.m) == (Uj.n, Uj.m)
    assert np.array_equal(Ut.indptr, Uj.indptr)
    assert np.array_equal(Ut.indices[:Ut.nnz], Uj.indices[:Uj.nnz])
    assert np.array_equal(Ut.data[:Ut.nnz], Uj.data[:Uj.nnz])


@pytest.mark.parametrize("name,p", [("mat364.sms", 42013),
                                    ("trefethen_500.sms", 257),
                                    ("lower_trapeze.sms", 42013),
                                    ("singular2.sms", 65269)])
def test_finisher_matches_jax_device_finisher(name, p):
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    _same_factor(jechelonize(J, JOpts(**DEVICE_MIN0)),
                 echelonize(A, EchelonizeOptions(**DEVICE_MIN0),
                            device="cpu"))


def test_tall_input_lowrank_and_completion(caplog):
    """Remaining rows / free columns > 5 and rank below the free width:
    the finisher draws random combinations (lowrank mode), and only the
    completion test can stop it (its range is on the profiler's
    timeline)."""
    p = 42013
    rng = np.random.default_rng(5)
    C = np.where(rng.random((1500, 40)) < 0.08,
                 rng.integers(1, p, (1500, 40)), 0)
    B = np.where(rng.random((40, 200)) < 0.05,
                 rng.integers(1, p, (40, 200)), 0)
    D = (C @ B) % p
    acts = [torch.profiler.ProfilerActivity.CPU]
    with caplog.at_level("INFO", logger="spasm_tpu_torch"), \
            torch.profiler.profile(activities=acts) as prof:
        t = echelonize(CSR.from_dense(D, p),
                       EchelonizeOptions(**DEVICE_MIN0), device="cpu")
    assert "lowrank mode" in caplog.text
    names = {e.name for e in prof.events()}
    assert "spasm/completion" in names and t.r <= 40
    _same_factor(jechelonize(JCSR.from_dense(D, p), JOpts(**DEVICE_MIN0)), t)


@pytest.mark.parametrize("opts", [dict(L=True), dict(complete=True)])
def test_l_mode_matches_jax(opts):
    """L-mode on mat364: the host L block of finish_dense; rank, qinv, U,
    L and p bit-equal to the JAX package's."""
    p = 42013
    J, _ = jsio.load_csr(MATRIX / "mat364.sms", p)
    A, _ = sio.load_csr(MATRIX / "mat364.sms", p)
    j = jechelonize(J, JOpts(**opts))
    t = echelonize(A, EchelonizeOptions(**opts), device="cpu")
    _same_factor(j, t)
    assert np.array_equal(t.p, j.p) and t.complete == j.complete
    Lj, Lt = j.L, t.L
    assert np.array_equal(Lt.indptr, Lj.indptr)
    assert np.array_equal(Lt.indices[:Lt.nnz], Lj.indices[:Lj.nnz])
    assert np.array_equal(Lt.data[:Lt.nnz], Lj.data[:Lj.nnz])


def test_large_prime_raises():
    """65537 no longer raises: the device finisher (its int32 basis, the
    torch step sweep) gives mat364 the rank of the JAX host path (the
    JAX device finisher wraps there, ROADMAP C1), and U is an echelon
    basis of A's row space."""
    J, _ = jsio.load_csr(MATRIX / "mat364.sms", 65537)
    A, _ = sio.load_csr(MATRIX / "mat364.sms", 65537)
    fact = echelonize(A, EchelonizeOptions(**DEVICE_MIN0), device="cpu")
    assert fact.r == jechelonize(J, JOpts(enable_dense=False)).r == 364
    U = fact.U
    for i in range(U.n):
        cols, vals = U.row(i)
        assert vals[0] == 1 and fact.qinv[cols[0]] == i
    x = np.zeros(A.m, dtype=np.int64)
    for i in range(A.n):
        pattern, x = sparse_triangular_solve(U, A, i, fact.qinv, x)
        assert not np.any(x[pattern][fact.qinv[pattern] < 0])


@pytest.mark.parametrize("name,want", [("u1.sms", "100"),
                                       ("example.sms", "8"),
                                       ("empty.sms", "0"),
                                       # sparse round-0 Schur complements
                                       ("dm.sms", "8"), ("cc.sms", "2"),
                                       ("BIOMD0000000424.int.mpl.sms",
                                        "41")])
@pytest.mark.parametrize("modulus", ["42013", "4294967291"])
def test_rank_cli(name, want, modulus, capsys, monkeypatch):
    # the tool runs the finisher on the card; here it gets the CPU
    monkeypatch.setattr(rank_cli, "echelonize",
                        functools.partial(echelonize, device="cpu"))
    assert rank_cli.main(["--modulus", modulus,
                          "--matrix", str(MATRIX / name)]) == 0
    assert capsys.readouterr().out.strip() == want


@pytest.mark.parametrize("flag", ["--device"])
def test_rank_cli_rejects_unported_flags(flag):
    with pytest.raises(SystemExit):
        rank_cli.main([flag, "1", "--matrix", str(MATRIX / "u1.sms")])


@pytest.mark.parametrize("flag,value,field", [
    ("--dense-block-size", "123", "dense_block_size"),
    ("--min-rank-ratio", "0.25", "low_rank_ratio")])
def test_rank_cli_dense_flags_reach_the_options(flag, value, field,
                                                monkeypatch, capsys):
    seen = {}

    def spy(A, opts):
        seen["opts"] = opts
        return echelonize(A, opts, device="cpu")

    monkeypatch.setattr(rank_cli, "echelonize", spy)
    assert rank_cli.main([flag, value, "--matrix",
                          str(MATRIX / "mat364.sms")]) == 0
    assert capsys.readouterr().out.strip() == "364"
    assert getattr(seen["opts"], field) == type(
        getattr(EchelonizeOptions(), field))(value)


@pytest.mark.parametrize("name", ["mat364.sms", "singular2.sms"])
def test_no_round_finisher_takes_all(name):
    """max_round=0: no structural pivots; the finisher gets every row."""
    p = 42013
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    opts = dict(DEVICE_MIN0, max_round=0)
    _same_factor(jechelonize(J, JOpts(**opts)),
                 echelonize(A, EchelonizeOptions(**opts), device="cpu"))


def test_rank_cli_certificate_and_checkpoint(capsys, caplog, monkeypatch,
                                             tmp_path):
    """--certificate is ported: the tool certifies the rank.  And
    --checkpoint: a run preempted right after its first snapshot
    resumes from the file, prints the uninterrupted run's output and
    removes the file."""
    monkeypatch.setattr(rank_cli, "echelonize",
                        functools.partial(echelonize, device="cpu"))
    assert rank_cli.main(["--certificate", "--matrix",
                          str(MATRIX / "u1.sms")]) == 0
    out = capsys.readouterr()
    assert out.out.strip() == "100" and "CORRECT certificate" in out.err
    argv = ["--matrix", str(MATRIX / "mat364.sms")]
    assert rank_cli.main(argv) == 0
    want = capsys.readouterr().out
    ckfile = tmp_path / "ckpt"
    real = ckpt.save_checkpoint

    def preempted(*a, **kw):
        real(*a, **kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save_checkpoint", preempted)
    with pytest.raises(KeyboardInterrupt):
        rank_cli.main(argv + ["--checkpoint", str(ckfile)])
    assert ckfile.exists()
    capsys.readouterr()
    monkeypatch.setattr(ckpt, "save_checkpoint", real)
    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        assert rank_cli.main(argv + ["--checkpoint", str(ckfile)]) == 0
    assert capsys.readouterr().out == want == "364\n"
    assert "[checkpoint] resumed" in caplog.text
    assert not ckfile.exists()
