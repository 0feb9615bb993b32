"""Checkpoint/resume of the port's echelonization engine
(spasm_tpu_torch/checkpoint.py) on the CPU, against the JAX package.

Twins of every case of tests/test_checkpoint.py (preemption simulated by
an exception raised after the k-th snapshot); then the parity that makes
the files interchangeable: at every save the port writes the same
arrays, key by key, as the JAX package, and each package resuming a file
written by the other gives the factorization (rank, qinv, U, and L and p
in complete mode) that the writer itself gives resuming it.  Tolerance
0 throughout.  The rank tool resumes through --checkpoint, in-process and
in a fresh process after a child killed by SIGKILL."""
import functools
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import checkpoint as jckpt
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import sio as jsio
from spasm_tpu.csr import COO as JCOO
from spasm_tpu.gen import matching_complex_boundary as jmcb

from spasm_tpu_torch import COO, EchelonizeOptions, echelonize, sio, spmv
from spasm_tpu_torch import checkpoint as ckpt
from spasm_tpu_torch.cli import echelonize as echelonize_cli
from spasm_tpu_torch.cli import kernel as kernel_cli
from spasm_tpu_torch.cli import rank as rank_cli
from spasm_tpu_torch.cli import solve as solve_cli
from spasm_tpu_torch.echelonize import _Engine
from spasm_tpu_torch.gen import matching_complex_boundary as mcb
from spasm_tpu_torch.triangular import sparse_triangular_solve
from tests.conftest import MATRIX

torch.set_num_threads(2)

ROOT = MATRIX.parent.parent
P4 = 4294967291                      # 2^32 - 5, the top of the d = 4 tier
# every key a file may hold; none of them names a device
KEYS = {"version", "fingerprint", "prime", "m", "want_L", "complete",
        "phase", "rnd", "status", "npiv", "density", "processed", "u_cols",
        "u_vals", "u_offs", "u_pivcol", "qinv", "Lp", "s_indptr",
        "s_indices", "s_data", "s_shape", "p_in", "p", "l_rows", "l_cols",
        "l_vals"}


class _Preempt(RuntimeError):
    pass


def _preempting_save(monkeypatch, after: int, mod=ckpt, files=None):
    """Patch mod.save_checkpoint to raise after the `after`-th snapshot
    (never, for after=0); each snapshot's arrays are appended to `files`
    when given."""
    real = mod.save_checkpoint
    count = {"n": 0}

    def wrapper(path, **kw):
        real(path, **kw)
        count["n"] += 1
        if files is not None:
            with np.load(path) as z:
                files.append({k: z[k] for k in z.files})
        if count["n"] == after:
            raise _Preempt()

    monkeypatch.setattr(mod, "save_checkpoint", wrapper)
    return count


def _dense_synthetic(n, m, p, seed=7, coo=COO):
    """tests/test_checkpoint.py's matrix: its Schur complement densifies
    (the rounds stop, finish_dense runs)."""
    rng = np.random.default_rng(seed)
    w = 6
    rows = np.repeat(np.arange(n, dtype=np.int64), w)
    cols = rng.integers(0, m, size=n * w)
    vals = rng.integers(1, p, size=n * w)
    T = coo.from_entries(n, m, p, rows, cols, vals)
    T.n, T.m = n, m
    return T.tocsr()


def _echelon_form_check(U, qinv_out):
    qinv = np.full(U.m, -1, np.int64)
    for i in range(U.n):
        cols, vals = U.row(i)
        assert cols.size > 0 and qinv[cols[0]] == -1 and vals[0] == 1
        qinv[cols[0]] = i
    assert np.array_equal(qinv, np.asarray(qinv_out, np.int64))


def _inclusion_check(A, U, qinv):
    """Every row of A reduces to zero against U."""
    x = np.zeros(A.m, dtype=np.int64)
    for i in range(A.n):
        pattern, x = sparse_triangular_solve(U, A, i, qinv, x)
        assert not np.any(x[pattern][qinv[pattern] < 0])


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
    assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])


def _same_factor(a, b, with_L):
    assert a.r == b.r
    assert np.array_equal(a.qinv, b.qinv)
    _same_csr(a.U, b.U)
    if with_L:
        assert np.array_equal(a.p, b.p) and a.complete == b.complete
        _same_csr(a.L, b.L)


# -- twins of tests/test_checkpoint.py -----------------------------------

@pytest.mark.parametrize("after", [1, 2])
def test_resume_after_preemption(tmp_path, monkeypatch, after):
    p = 42013
    A = _dense_synthetic(600, 600, p)
    ref = echelonize(A.copy(), device="cpu")

    ckfile = str(tmp_path / "state.ck")
    opts = EchelonizeOptions(checkpoint_file=ckfile, dense_block_size=64,
                             checkpoint_interval_s=0.0)
    count = _preempting_save(monkeypatch, after)
    with pytest.raises(_Preempt):
        echelonize(A.copy(), opts, device="cpu")
    assert (tmp_path / "state.ck").exists()
    assert count["n"] == after

    monkeypatch.undo()                   # resume: no more preemption
    fact = echelonize(A.copy(), opts, device="cpu")
    assert fact.r == ref.r
    _echelon_form_check(fact.U, fact.qinv)
    _inclusion_check(A, fact.U, fact.qinv)
    assert not (tmp_path / "state.ck").exists()    # removed on success


def test_resume_with_L(tmp_path, monkeypatch):
    """PLUQ mode: the resumed factorization still satisfies A == L @ U."""
    p = 257
    A, _ = sio.load_csr(MATRIX / "medium.sms", p)
    ref = echelonize(A.copy(), device="cpu")

    ckfile = str(tmp_path / "state.ck")
    opts = EchelonizeOptions(L=True, complete=True, checkpoint_file=ckfile,
                             dense_block_size=32,
                             checkpoint_interval_s=0.0)
    _preempting_save(monkeypatch, 1)
    with pytest.raises(_Preempt):
        echelonize(A.copy(), opts, device="cpu")
    monkeypatch.undo()
    fact = echelonize(A.copy(), opts, device="cpu")
    assert fact.r == ref.r
    F = A.field
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = rng.integers(0, p, size=A.n).astype(np.int64)
        xA = spmv.xApy(x, A, np.zeros(A.m, np.int64))
        xL = spmv.xApy(x, fact.L, np.zeros(fact.L.m, np.int64))
        xLU = spmv.xApy(xL, fact.U, np.zeros(A.m, np.int64))
        assert np.array_equal(F.narray(xA), F.narray(xLU))


def test_checkpoint_rejects_wrong_matrix(tmp_path, monkeypatch):
    """A snapshot of another input is ignored, not resumed."""
    p = 42013
    A = _dense_synthetic(300, 300, p, seed=1)
    B = _dense_synthetic(300, 300, p, seed=2)
    ckfile = str(tmp_path / "state.ck")
    opts = EchelonizeOptions(checkpoint_file=ckfile, dense_block_size=64)
    _preempting_save(monkeypatch, 1)
    with pytest.raises(_Preempt):
        echelonize(A.copy(), opts, device="cpu")
    monkeypatch.undo()
    ref_b = echelonize(B.copy(), device="cpu")
    fact = echelonize(B.copy(), opts, device="cpu")   # a fresh run
    assert fact.r == ref_b.r
    _echelon_form_check(fact.U, fact.qinv)
    _inclusion_check(B, fact.U, fact.qinv)


def test_checkpoint_roundtrip_state(tmp_path):
    """Low level: a saved snapshot restores to an identical engine."""
    p = 257
    A, _ = sio.load_csr(MATRIX / "medium.sms", p)
    eng = _Engine(A, EchelonizeOptions(), "cpu")
    npiv, prows = eng.extract_structural(A, None)
    assert npiv > 0
    fp = ckpt.matrix_fingerprint(A)
    path = str(tmp_path / "s.ck")
    ckpt.save_checkpoint(path, fingerprint=fp, engine=eng, S=A, p_in=None,
                         rnd=1, phase=ckpt.PHASE_ROUND, density=0.01)
    state = ckpt.load_checkpoint(path, fp, p, False)
    assert state is not None
    eng2 = _Engine(A, EchelonizeOptions(), "cpu")
    ckpt.restore_engine(eng2, state)
    assert eng2.U.n == eng.U.n
    assert np.array_equal(eng2.U.qinv, eng.U.qinv)
    _same_csr(eng.U.snapshot_csr(), eng2.U.snapshot_csr())
    S2 = ckpt.restored_S(state, p)
    assert S2.n == A.n and S2.m == A.m and S2.nnz == A.nnz
    # wrong prime / wrong fingerprint / wrong `complete` are refused
    assert ckpt.load_checkpoint(path, fp, 65537, False) is None
    assert ckpt.load_checkpoint(path, b"\0" * 32, p, False) is None
    assert ckpt.load_checkpoint(path, fp, p, False, complete=True) is None
    # a stale mid-save orphan is cleaned up on load
    orphan = path + ".ck.tmp"
    open(orphan, "wb").write(b"partial")
    assert ckpt.load_checkpoint(path, fp, p, False) is not None
    assert not os.path.exists(orphan)


# -- the same files, and each package resuming the other's ---------------

# (input, options): "dense" reaches PHASE_FINISH and one PHASE_DENSE
# save; "rounds" lifts the density stop, so the rounds run (PHASE_ROUND
# saves) and GPLU finishes after PHASE_FINISH
INPUTS = {"synthetic600": (42013, dict(dense_block_size=64)),
          "medium": (257, dict(dense_block_size=32))}
ROUNDS = dict(sparsity_threshold=1.0, min_pivot_proportion=0.0)


def _pair(name):
    """(JAX CSR, port CSR, p) of one input."""
    p = INPUTS[name][0]
    if name == "synthetic600":
        return (_dense_synthetic(600, 600, p, coo=JCOO),
                _dense_synthetic(600, 600, p), p)
    return (jsio.load_csr(MATRIX / "medium.sms", p)[0],
            sio.load_csr(MATRIX / "medium.sms", p)[0], p)


def _opts(name, loop, complete, ckfile):
    kw = dict(INPUTS[name][1], checkpoint_file=ckfile,
              checkpoint_interval_s=0.0, complete=complete)
    if loop == "rounds":
        kw.update(ROUNDS)
    return kw


def _jax(A, kw):
    return jechelonize(A.copy(), JOpts(**kw))


def _port(A, kw):
    return echelonize(A.copy(), EchelonizeOptions(**kw), device="cpu")


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("loop", ["dense", "rounds"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_same_file_at_every_save(tmp_path, monkeypatch, name, loop,
                                 complete):
    """Uninterrupted runs of both packages write, at each save, files
    whose arrays are equal key by key (fingerprint included); the saves
    reach the phases the loop is meant to reach."""
    J, A, _ = _pair(name)
    jfiles, tfiles = [], []
    _preempting_save(monkeypatch, 0, jckpt, jfiles)
    _preempting_save(monkeypatch, 0, ckpt, tfiles)
    kw = _opts(name, loop, complete, str(tmp_path / "j.ck"))
    j = _jax(J, kw)
    t = _port(A, dict(kw, checkpoint_file=str(tmp_path / "t.ck")))
    assert t.r == j.r and len(tfiles) == len(jfiles)
    phases = [int(f["phase"]) for f in tfiles]
    assert phases == [int(f["phase"]) for f in jfiles]
    if loop == "dense":
        assert phases == [ckpt.PHASE_FINISH, ckpt.PHASE_DENSE]
    else:
        assert phases[0] == ckpt.PHASE_ROUND and phases[-1] == \
            ckpt.PHASE_FINISH
    for jf, tf in zip(jfiles, tfiles):
        assert set(tf) == set(jf) and set(tf) <= KEYS
        assert ("l_rows" in tf) == complete
        for k in jf:
            assert tf[k].dtype == jf[k].dtype, k
            assert np.array_equal(tf[k], jf[k]), k
    assert not os.listdir(tmp_path)          # both files removed


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name,loop,complete,after", [
    ("synthetic600", "dense", False, 1),      # PHASE_FINISH
    ("synthetic600", "dense", False, 2),      # PHASE_DENSE
    ("synthetic600", "dense", True, 2),       # PHASE_DENSE, L
    ("medium", "rounds", False, 1),           # PHASE_ROUND
    ("medium", "rounds", True, 1),            # PHASE_ROUND, L
])
def test_cross_resume(tmp_path, monkeypatch, writer, name, loop, complete,
                      after):
    """A file written by one package (preempted after its `after`-th
    save) resumed by the other gives the factorization the writer gives
    resuming the same file."""
    J, A, _ = _pair(name)
    ckfile = str(tmp_path / "w.ck")
    kw = _opts(name, loop, complete, ckfile)
    _preempting_save(monkeypatch, after, jckpt if writer == "jax" else ckpt)
    with pytest.raises(_Preempt):
        _jax(J, kw) if writer == "jax" else _port(A, kw)
    monkeypatch.undo()
    shutil.copy(ckfile, tmp_path / "j.ck")
    shutil.copy(ckfile, tmp_path / "t.ck")
    j = _jax(J, dict(kw, checkpoint_file=str(tmp_path / "j.ck")))
    t = _port(A, dict(kw, checkpoint_file=str(tmp_path / "t.ck")))
    _same_factor(j, t, complete)
    assert sorted(os.listdir(tmp_path)) == ["w.ck"]


def test_wide_prime_round_resume(tmp_path, monkeypatch):
    """mk10.b3 at 2^32 - 5, default options: round 0's sparse Schur
    complement (through the reduced basis), the PHASE_ROUND save, then
    round 1 and GPLU.  The JAX device finisher (whose int16 basis wraps
    above 65535, ROADMAP C1) never engages on this path, so the JAX
    package is the oracle: its file at that save equals the port's, and
    both packages resuming the port's file give the factorization of the
    port's own uninterrupted run."""
    J, A = jmcb(10, 3, P4), mcb(10, 3, P4)
    if A.n < A.m:
        J, A = J.transpose(), A.transpose()
    ref = echelonize(A.copy(), device="cpu")
    jfiles, tfiles = [], []
    kw = dict(checkpoint_file=str(tmp_path / "j.ck"))
    _preempting_save(monkeypatch, 1, jckpt, jfiles)
    _preempting_save(monkeypatch, 1, ckpt, tfiles)
    with pytest.raises(_Preempt):
        _jax(J, kw)
    with pytest.raises(_Preempt):
        _port(A, dict(checkpoint_file=str(tmp_path / "t.ck")))
    monkeypatch.undo()
    (jf,), (tf,) = jfiles, tfiles
    assert int(tf["phase"]) == ckpt.PHASE_ROUND and int(tf["rnd"]) == 1
    assert set(tf) == set(jf)
    for k in jf:
        assert np.array_equal(tf[k], jf[k]), k
    shutil.copy(tmp_path / "t.ck", tmp_path / "j.ck")
    j = _jax(J, kw)
    t = _port(A, dict(checkpoint_file=str(tmp_path / "t.ck")))
    assert t.r == ref.r == 2564
    _same_factor(ref, t, False)
    _same_factor(ref, j, False)
    assert not os.listdir(tmp_path)


def test_restore_places_state_on_the_run_device(tmp_path, monkeypatch):
    """A file written with device="cpu" holds host arrays only; the
    restored engine's U is a host store and its chunk basis is composed
    on the resuming engine's device (the CPU here; the card in
    tests/test_torch_cuda.py)."""
    A = _dense_synthetic(600, 600, 42013)
    ckfile = str(tmp_path / "s.ck")
    _preempting_save(monkeypatch, 1)
    with pytest.raises(_Preempt):
        _port(A, dict(checkpoint_file=ckfile))
    monkeypatch.undo()
    with np.load(ckfile) as z:
        assert set(z.files) <= KEYS
        assert all(z[k].dtype != object for k in z.files)
    state = ckpt.load_checkpoint(ckfile, ckpt.matrix_fingerprint(A),
                                 A.prime, False)
    dev = torch.device("cpu")
    eng = _Engine(A, EchelonizeOptions(), dev)
    ckpt.restore_engine(eng, state)
    assert eng.elim.nrows == eng.U.n == len(state["u_pivcol"]) > 0
    eng.elim.flush()
    tensors = [t for run in eng.elim.runs for t in run
               if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device == dev for t in tensors)
    assert not eng.U._pending


# -- the tools ------------------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (rank_cli, []), (echelonize_cli, []), (kernel_cli, []),
    (solve_cli, ["--rhs", str(MATRIX / "mat364.sms")])])
def test_tools_resume_through_checkpoint(tool, argv, tmp_path, monkeypatch,
                                         capsys):
    """rank, echelonize, kernel and solve preempted after their first
    save resume through --checkpoint: the same standard output as an
    uninterrupted run, and the file removed."""
    on_cpu = functools.partial(echelonize, device="cpu")
    monkeypatch.setattr(tool, "echelonize", on_cpu)
    base = ["--matrix", str(MATRIX / "mat364.sms")] + argv
    assert tool.main(base) == 0
    want = capsys.readouterr().out
    ckfile = str(tmp_path / "tool.ck")
    _preempting_save(monkeypatch, 1)
    with pytest.raises(_Preempt):
        tool.main(base + ["--checkpoint", ckfile])
    assert os.path.exists(ckfile)
    capsys.readouterr()
    monkeypatch.undo()
    monkeypatch.setattr(tool, "echelonize", on_cpu)
    assert tool.main(base + ["--checkpoint", ckfile]) == 0
    assert capsys.readouterr().out == want
    assert not os.path.exists(ckfile)


# the rank tool's main in a fresh process, its finisher on the CPU (the
# tool itself has no --device: it runs on the card); the child also
# kills itself with SIGKILL right after its first save
_RANK = ("import functools, sys\n"
         "from spasm_tpu_torch import echelonize\n"
         "from spasm_tpu_torch.cli import rank\n"
         "rank.echelonize = functools.partial(echelonize, device='cpu')\n")
_KILL = ("import os, signal\n"
         "from spasm_tpu_torch import checkpoint\n"
         "real = checkpoint.save_checkpoint\n"
         "def save(*a, **kw):\n"
         "    real(*a, **kw)\n"
         "    os.kill(os.getpid(), signal.SIGKILL)\n"
         "checkpoint.save_checkpoint = save\n")


def _rank_process(code, argv):
    return subprocess.run(
        [sys.executable, "-c", code + "sys.exit(rank.main(sys.argv[1:]))"]
        + argv, capture_output=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_rank_tool_resumes_after_sigkill(tmp_path):
    """A rank process killed by SIGKILL right after its first snapshot
    leaves the file; a fresh process given the same --checkpoint resumes
    from it, prints the uninterrupted run's rank and removes the file."""
    ckfile = str(tmp_path / "rank.ck")
    argv = ["--matrix", str(MATRIX / "trefethen_500.sms")]
    want = _rank_process(_RANK, argv)
    assert want.returncode == 0 and want.stdout.strip() == b"500"
    child = _rank_process(_RANK + _KILL, argv + ["--checkpoint", ckfile])
    assert child.returncode == -signal.SIGKILL and child.stdout == b""
    assert os.path.exists(ckfile)
    resumed = _rank_process(_RANK, argv + ["--checkpoint", ckfile])
    assert resumed.returncode == 0, resumed.stderr.decode()
    assert b"[checkpoint] resumed" in resumed.stderr
    assert resumed.stdout == want.stdout
    assert not os.path.exists(ckfile)
