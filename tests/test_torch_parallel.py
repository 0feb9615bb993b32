"""The mesh (spasm_tpu_torch/parallel/) on the CPU, against the JAX
package's mesh on the 8 virtual CPU devices that conftest.py gives it.

The port's meshes repeat torch.device("cpu"): 8 of them ((4, 2)) and 4
((2, 2)).  One process drives every shard, so a repeated device runs every
sharded stage (row-sharded block elimination and densified blocks, the
column-sharded dense elimination and reduced basis, the collectives
between them).  Twins of every test of tests/test_parallel.py and of
`dryrun_multichip`'s steps 1-5 (__graft_entry__.py); each result is held
to the JAX package's, single-device and on its mesh, and to the port's
own single-device run.  GF(p) arithmetic is exact: tolerance 0."""
import functools
import shutil

import jax
import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import sio as jsio
from spasm_tpu.csr import COO as JCOO
from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.dense.elim import dense_rref as jdense_rref
from spasm_tpu.gen import matching_complex_boundary as jmcb
from spasm_tpu.parallel.context import use_mesh as juse_mesh
from spasm_tpu.parallel.dist import make_mesh as jmake_mesh

from spasm_tpu_torch import COO, CSR, EchelonizeOptions, echelonize, sio
from spasm_tpu_torch import checkpoint as ckpt
from spasm_tpu_torch.dense.elim import dense_rref
from spasm_tpu_torch.echelonize import _Engine
from spasm_tpu_torch.gen import matching_complex_boundary as mcb
from spasm_tpu_torch.parallel import context as mesh_ctx
from spasm_tpu_torch.parallel import make_mesh, use_mesh
from spasm_tpu_torch.parallel.dist import Mesh
from tests.conftest import MATRIX

torch.set_num_threads(2)

CPU = torch.device("cpu")
SIZES = [8, 4]                     # (4, 2) and (2, 2)
P = 42013


def cpu_mesh(n: int) -> Mesh:
    return make_mesh(devices=[CPU] * n)


@functools.lru_cache(maxsize=None)
def jmesh(n: int):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual JAX devices")
    return jmake_mesh(devices=jax.devices()[:n])


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
    assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])


def _same_factor(a, b, with_L=False):
    assert a.r == b.r
    assert np.array_equal(a.qinv, b.qinv)
    _same_csr(a.U, b.U)
    if with_L:
        assert np.array_equal(a.p, b.p)
        _same_csr(a.L, b.L)


def _random_rows(n, m, w, seed, p=P):
    """test_parallel.py's / dryrun_multichip's instances: w entries a row
    (both packages' COO from the same numpy draws)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), w)
    cols = rng.integers(0, m, n * w)
    vals = rng.integers(1, p, n * w)
    out = []
    for coo in (JCOO, COO):
        T = coo.from_entries(n, m, p, rows, cols, vals)
        T.n, T.m = n, m
        out.append(T.tocsr())
    return out


def _jax_runs(J, jopts, n):
    """(single-device, mesh of n) JAX factorizations of J."""
    single = jechelonize(J.copy(), jopts)
    with juse_mesh(jmesh(n)):
        mesh = jechelonize(J.copy(), jopts)
        mesh.U, mesh.L            # materialize inside the mesh context
    return single, mesh


# -- the mesh itself -----------------------------------------------------

@pytest.mark.parametrize("n,shape", [(8, (4, 2)), (4, (2, 2)), (2, (2, 1)),
                                     (1, (1, 1))])
def test_mesh_shape(n, shape):
    mesh = cpu_mesh(n)
    assert mesh.devices.shape == shape and mesh.size == n
    assert set(mesh.axis_names) == {"rows", "cols"}
    assert mesh.shape == {"rows": shape[0], "cols": shape[1]}
    assert mesh.shape == dict(jmesh(n).shape)
    assert all(d == CPU for d in mesh.devices.ravel())


@pytest.mark.parametrize("n", SIZES)
def test_two_level_mesh(n):
    """An injected process_of that splits the devices evenly gives rows =
    processes, cols = devices per process (dryrun_multichip step 5's
    mesh), as in the JAX package; an uneven split falls back to the
    single-level factorization."""
    devs = [torch.device("cpu", i) for i in range(n)]
    half = n // 2
    mesh = make_mesh(devices=devs, process_of=lambda d: d.index // half)
    jdevs = jax.devices()[:n]
    jm = jmake_mesh(devices=jdevs, process_of=lambda d: jdevs.index(d) // half)
    assert mesh.shape == dict(jm.shape) == {"rows": 2, "cols": half}
    assert [[d.index for d in row] for row in mesh.devices] == \
        [list(range(half)), list(range(half, n))]
    # processes listed out of order still give rows in process order
    mesh = make_mesh(devices=devs[::-1], process_of=lambda d: d.index // half)
    assert [[d.index for d in row] for row in mesh.devices] == \
        [list(range(half - 1, -1, -1)), list(range(n - 1, half - 1, -1))]
    uneven = make_mesh(devices=devs, process_of=lambda d: int(d.index == 0))
    assert uneven.shape == cpu_mesh(n).shape


def test_make_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(devices=[])


def test_without_mesh_every_placement_is_the_identity():
    X = torch.arange(12).reshape(3, 4)
    assert mesh_ctx.current_mesh() is None
    for f in (mesh_ctx.shard_rows, mesh_ctx.shard_cols, mesh_ctx.replicated,
              mesh_ctx.gather):
        assert f(X) is X
    assert mesh_ctx.row_quantum() == mesh_ctx.col_quantum() == 1


def test_replicas_on_a_repeated_device_do_not_alias():
    """A device repeats in the mesh, and the engine updates shards in
    place: every placement must be a copy, so writing one shard or
    replica leaves the source and every other shard as they were."""
    mesh = cpu_mesh(8)
    X = torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)
    X0 = X.clone()
    rows = mesh_ctx.shard_rows(X, mesh)
    cols = mesh_ctx.shard_cols(X[:, :4], mesh)
    reps = mesh_ctx.replicated(X, mesh)
    copies = mesh_ctx.broadcast(X, [CPU, CPU])
    every = rows.shards + cols.shards + reps.shards + copies
    assert len(rows.shards) == len(reps.shards) == 4 and len(cols.shards) == 2
    ptrs = [t.untyped_storage().data_ptr() for t in every]
    assert len(set(ptrs)) == len(ptrs)
    assert X.untyped_storage().data_ptr() not in ptrs
    for t in every:
        t.fill_(-1)
    assert torch.equal(X, X0)
    assert torch.equal(mesh_ctx.gather(mesh_ctx.shard_rows(X, mesh)), X)
    assert torch.equal(mesh_ctx.gather(mesh_ctx.shard_cols(X[:, :4], mesh)),
                       X[:, :4])
    with pytest.raises(ValueError):
        mesh_ctx.shard_rows(X[:6], mesh)           # 6 rows, 4 row shards


def test_counters_cover_every_site():
    """Sites 1-7 each count a call over one run of every engine path
    (lower_trapeze: the low-rank finisher, pad_block; mat364: the dense
    finisher; mk10.b3 complete: the sparse Schur rounds' device branch;
    the rank finisher on 256 rows; mk10.b3 rounds through the reduced
    basis), and the bytes they move are counted."""
    mesh_ctx.reset_counts()
    with use_mesh(cpu_mesh(4)):
        for name in ("lower_trapeze.sms", "mat364.sms"):
            echelonize(sio.load_csr(MATRIX / name, P)[0])
        _, A10 = _mk10()
        echelonize(A10, EchelonizeOptions(complete=True))
        echelonize(A10, EchelonizeOptions(max_round=1))
        echelonize(_random_rows(256, 256, 4, 3)[1],
                   EchelonizeOptions(device_dense_min=0))
    assert all(mesh_ctx.site_calls[s] > 0 for s in mesh_ctx.SITES), \
        mesh_ctx.site_calls
    assert all(mesh_ctx.moved_bytes[s] > 0 for s in range(1, 7))
    mesh_ctx.reset_counts()
    assert not any(mesh_ctx.site_calls.values())


def test_echelonize_refuses_another_device_type_under_a_mesh():
    A, _ = sio.load_csr(MATRIX / "small.sms", P)
    with use_mesh(cpu_mesh(4)):
        with pytest.raises(ValueError, match="mesh"):
            echelonize(A, device="cuda")
        assert echelonize(A, device="cpu").r == echelonize(A).r


# -- twins of tests/test_parallel.py -------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_device_finisher_on_mesh_matches(n):
    """The rank finisher (combination forming, chunked elimination,
    compaction, row-sweep RREF) under a mesh: the JAX rank, single and
    mesh, and the port's single-device factorization bit for bit."""
    J, A = _random_rows(256, 256, 4, 3)
    opts = dict(device_dense_min=0)
    js, jm = _jax_runs(J, JOpts(**opts), n)
    ref = echelonize(A.copy(), EchelonizeOptions(**opts), device="cpu")
    with use_mesh(cpu_mesh(n)):
        got = echelonize(A.copy(), EchelonizeOptions(**opts))
    assert got.r == js.r == jm.r
    _same_factor(got, ref)
    _same_factor(got, js)


@pytest.mark.parametrize("n", SIZES)
def test_echelonize_on_mesh_matches(n):
    """mat364, default options (the dense finisher: row-sharded Schur
    block, column-sharded RREF): U and qinv bit-equal to both JAX runs."""
    J, _ = jsio.load_csr(MATRIX / "mat364.sms", P)
    A, _ = sio.load_csr(MATRIX / "mat364.sms", P)
    js, jm = _jax_runs(J, JOpts(), n)
    with use_mesh(cpu_mesh(n)):
        got = echelonize(A.copy())
    _same_factor(got, js)
    _same_factor(got, jm)


@pytest.mark.parametrize("n", SIZES)
def test_echelonize_on_mesh_with_L(n):
    """Complete PLUQ on the mesh: L, U and p bit-equal to both JAX runs,
    and A == L @ U."""
    J, _ = jsio.load_csr(MATRIX / "singular.sms", 257)
    A, _ = sio.load_csr(MATRIX / "singular.sms", 257)
    js, jm = _jax_runs(J, JOpts(complete=True), n)
    with use_mesh(cpu_mesh(n)):
        fact = echelonize(A.copy(), EchelonizeOptions(complete=True))
    _same_factor(fact, js, True)
    _same_factor(fact, jm, True)
    got = A.field.narray(fact.L.todense().astype(object)
                         @ fact.U.todense().astype(object))
    assert np.array_equal(got, A.todense())


@functools.lru_cache(maxsize=None)
def _jax_rref(n, m, seed, dup):
    """test_parallel.py's / dryrun step 3's block, and the JAX package's
    RREF of it (single device and on its 8-device mesh)."""
    rng = np.random.default_rng(seed)
    S = rng.integers(-P // 2, P // 2 + 1, (n, m)).astype(np.int32)
    S[dup[0]:dup[0] + dup[1]] = S[0:dup[1]]       # planted rank deficiency
    want = jdense_rref(S, P, force="device")
    with juse_mesh(jmesh(8)):
        on_mesh = jdense_rref(S, P, force="device")
    return S, want, on_mesh


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [(1024, 1024, 7, (512, 32)),
                                  (128, 256, 1, (64, 16))],
                         ids=["1024x1024", "dryrun_128x256"])
def test_sharded_dense_rref_matches(n, case):
    """The column-sharded blocked RREF (B4's plain version per owner
    block, trailing updates per column shard) == the JAX RREF, single
    and sharded."""
    S, (wR, wpiv), (mR, mpiv) = _jax_rref(*case)
    with use_mesh(cpu_mesh(n)):
        R, piv = dense_rref(S, P, force="device", device="cpu")
    assert np.array_equal(piv, wpiv) and np.array_equal(piv, mpiv)
    assert np.array_equal(R, wR) and np.array_equal(R, mR)


# -- twins of dryrun_multichip (__graft_entry__.py) ----------------------

@pytest.mark.parametrize("n", SIZES)
def test_dryrun_engine_rank(n):
    """Step 1: the engine, device finisher forced, on the 96 x 96
    instance."""
    J, A = _random_rows(96, 96, 4, 1)
    opts = dict(device_dense_min=0)
    js, jm = _jax_runs(J, JOpts(**opts), n)
    ref = echelonize(A.copy(), EchelonizeOptions(**opts), device="cpu")
    with use_mesh(cpu_mesh(n)):
        got = echelonize(A.copy(), EchelonizeOptions(**opts))
    assert got.r == js.r == jm.r
    _same_factor(got, ref)


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_complete_pluq(n):
    """Step 2: complete PLUQ through the engine on the mesh."""
    J, A = _random_rows(96, 96, 4, 1)
    js, jm = _jax_runs(J, JOpts(complete=True), n)
    with use_mesh(cpu_mesh(n)):
        got = echelonize(A.copy(), EchelonizeOptions(complete=True))
    assert got.complete
    _same_factor(got, js, True)
    _same_factor(got, jm, True)


def _dense80():
    rng = np.random.default_rng(11)
    D = rng.integers(1, P, size=(80, 80)).astype(np.int64) % P
    return JCSR.from_dense(D, P), CSR.from_dense(D, P)


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_sp_width_cap(n, monkeypatch):
    """Step 4, the SP axis: dense 80 x 80 has one structural pivot, so 79
    free columns, above device_dense_width = 40 but under 40 * cols: the
    rank finisher runs only because the mesh's 'cols' axis multiplies
    the width cap (a spy shows it), and the rank is the JAX package's."""
    J, A = _dense80()
    want = jechelonize(J.copy(), JOpts()).r
    calls = []
    real = _Engine.finish_device_dense

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(_Engine, "finish_device_dense", spy)
    opts = EchelonizeOptions(device_dense_min=0, device_dense_width=40)
    echelonize(A.copy(), opts, device="cpu")
    assert not calls                       # one device: over the cap
    with use_mesh(cpu_mesh(n)):
        got = echelonize(A.copy(), opts)
    assert calls and got.r == want
    with juse_mesh(jmesh(n)):
        assert jechelonize(J.copy(), JOpts(device_dense_min=0,
                                           device_dense_width=40)).r == want


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_two_level_mesh_engine(n):
    """Step 5: the engine on the two-level mesh (2 processes x n/2
    devices, process_of injected)."""
    J, A = _random_rows(96, 96, 4, 1)
    devs = [torch.device("cpu", i) for i in range(n)]
    mesh = make_mesh(devices=devs, process_of=lambda d: d.index // (n // 2))
    opts = EchelonizeOptions(device_dense_min=0)
    ref = echelonize(A.copy(), opts, device="cpu")
    with use_mesh(mesh):
        got = echelonize(A.copy(), opts)
    assert got.r == jechelonize(J.copy(), JOpts(device_dense_min=0)).r
    _same_factor(got, ref)


# -- beyond the JAX tests ------------------------------------------------

def _mk10():
    J, A = jmcb(10, 3), mcb(10, 3)
    if A.n < A.m:
        J, A = J.transpose(), A.transpose()
    return J, A


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("opts", [dict(max_round=1), dict(complete=True)],
                         ids=["reduced_basis_round", "complete"])
def test_rounds_on_mesh_match(n, opts):
    """mk10.b3 (4725 x 3150): round 0's sparse Schur complement through
    the column-sharded reduced basis (sites 4, 5), or in L mode through
    the row-sharded densify and eliminator (sites 6, 2); equal to the
    port's single-device run and to the JAX package's."""
    _, A = _mk10()
    ref = echelonize(A, EchelonizeOptions(**opts), device="cpu")
    with use_mesh(cpu_mesh(n)):
        got = echelonize(A, EchelonizeOptions(**opts))
    _same_factor(got, ref, "complete" in opts)
    assert got.r == jechelonize(_mk10()[0], JOpts(**opts)).r == 2564


@pytest.mark.parametrize("n", SIZES)
def test_d4_prime_on_mesh(n):
    """A d = 4 prime (67108859): int32 storage, the torch step sweep and
    panel steps, B1 wide's plain version on each column shard; against
    the port's own single-device run (the JAX device finisher is off
    above 65535, ROADMAP C1)."""
    _, A = _random_rows(256, 256, 4, 3, p=67108859)
    for opts in (dict(device_dense_min=0), dict()):
        ref = echelonize(A.copy(), EchelonizeOptions(**opts), device="cpu")
        with use_mesh(cpu_mesh(n)):
            got = echelonize(A.copy(), EchelonizeOptions(**opts))
        _same_factor(got, ref)


class _Preempt(RuntimeError):
    pass


def _preempting_save(monkeypatch, after, files):
    real = ckpt.save_checkpoint
    count = {"n": 0}

    def wrapper(path, **kw):
        real(path, **kw)
        count["n"] += 1
        with np.load(path) as z:
            files.append({k: z[k] for k in z.files})
        if count["n"] == after:
            raise _Preempt()

    monkeypatch.setattr(ckpt, "save_checkpoint", wrapper)


def _dense_synthetic():
    """tests/test_checkpoint.py's 600 x 600 matrix (its Schur complement
    densifies: PHASE_FINISH, then PHASE_DENSE after each block)."""
    return _random_rows(600, 600, 6, 7)[1]


@pytest.mark.parametrize("writer", ["mesh", "single"])
def test_checkpoint_crosses_the_mesh(tmp_path, monkeypatch, writer):
    """A file written under a mesh equals the single-device file at every
    save, key by key (PHASE_FINISH, then PHASE_DENSE after the first
    block), and resumes without a mesh; a single-device file resumes
    under one.  Each resume gives the factorization of the single-device
    file resumed on one device."""
    A = _dense_synthetic()
    kw = dict(dense_block_size=64, checkpoint_interval_s=0.0)
    mesh = cpu_mesh(4)
    files = {"mesh": [], "single": []}
    for who in ("mesh", "single"):
        path = str(tmp_path / f"{who}.ck")
        _preempting_save(monkeypatch, 2, files[who])
        with pytest.raises(_Preempt):
            if who == "mesh":
                with use_mesh(mesh):
                    echelonize(A.copy(), EchelonizeOptions(
                        checkpoint_file=path, **kw))
            else:
                echelonize(A.copy(), EchelonizeOptions(checkpoint_file=path,
                                                       **kw), device="cpu")
        monkeypatch.undo()
    for a, b in zip(files["mesh"], files["single"], strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    shutil.copy(tmp_path / "single.ck", tmp_path / "ref.ck")
    ref = echelonize(A.copy(), EchelonizeOptions(
        checkpoint_file=str(tmp_path / "ref.ck"), **kw), device="cpu")
    assert ref.r == echelonize(A.copy(), device="cpu").r
    path = str(tmp_path / f"{writer}.ck")
    opts = EchelonizeOptions(checkpoint_file=path, **kw)
    if writer == "mesh":
        got = echelonize(A.copy(), opts, device="cpu")
    else:
        with use_mesh(mesh):
            got = echelonize(A.copy(), opts)
    _same_factor(got, ref)
