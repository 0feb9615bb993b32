"""The port's vendored host modules against the JAX package's, on the
same inputs: PRNG golden stream, SMS parsing and fingerprints, the
structural pivot search, the matching-complex generator, the no-JAX
import rule and the signatures of the exported consumers.  Tolerance 0 everywhere (exact integers)."""
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import spasm_tpu
import spasm_tpu.gen as jgen
from spasm_tpu import sio as jsio
from spasm_tpu.pivots import find_structural_pivots as j_pivots

import spasm_tpu_torch
import spasm_tpu_torch.gen as tgen
from spasm_tpu_torch import native as tnative
from spasm_tpu_torch import sio as tsio
from spasm_tpu_torch.hashing import PRNG
from spasm_tpu_torch.pivots import find_structural_pivots as t_pivots
from tests.conftest import MATRIX

torch.set_num_threads(2)

ALL_FIXTURES = sorted(p.name for p in MATRIX.glob("*.sms"))


def _line(prime, seed, seq):
    g = PRNG.from_u64(prime, seed, seq)
    vals = ", ".join(f"{g.zzp():6d}" for _ in range(10))
    return f"prime={prime}, seed={seed:016x}, seq={seq:08x}, out={vals}"


def test_prng_golden(expected_dir):
    lines = [_line(257, 0, 0), _line(257, 0, 1), _line(257, 1, 0),
             _line(257, 1, 1), _line(65537, 0xDEAD00000000BEEF, 0)]
    assert lines == (expected_dir / "prng").read_text().splitlines()


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_load_csr_identical(name):
    A, ha = jsio.load_csr(MATRIX / name, 42013, want_hash=True)
    B, hb = tsio.load_csr(MATRIX / name, 42013, want_hash=True)
    assert (A.n, A.m) == (B.n, B.m)
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices[:A.nnz], B.indices[:B.nnz])
    assert np.array_equal(A.data[:A.nnz], B.data[:B.nnz])
    assert ha == hb


@pytest.mark.parametrize("name", ["mat364.sms", "l1.sms", "medium.sms",
                                  "trefethen_500.sms", "dm.sms",
                                  "rectangular_l.sms"])
def test_structural_pivots_identical(name):
    A, _ = jsio.load_csr(MATRIX / name, 257)
    B, _ = tsio.load_csr(MATRIX / name, 257)
    for a, b in zip(j_pivots(A), t_pivots(B)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_matching_complex_identical():
    A = jgen.matching_complex_boundary(9, 3)
    B = tgen.matching_complex_boundary(9, 3)
    assert (A.n, A.m) == (B.n, B.m)
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


def test_import_leaves_jax_out():
    code = ("import sys, spasm_tpu_torch, spasm_tpu_torch.cli.rank, "
            "spasm_tpu_torch.interop; "
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "or m == 'spasm_tpu' or m.startswith('spasm_tpu.') "
            "for m in sys.modules) else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=MATRIX.parents[1],
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()


def test_native_builds_from_the_ports_own_source():
    """The host library compiles from the copy inside spasm_tpu_torch, and
    the pivot search it runs matches the JAX package's."""
    pkg = pathlib.Path(spasm_tpu_torch.__file__).resolve().parent
    assert tnative._SRC.resolve().is_relative_to(pkg)
    assert tnative._SRC.exists()
    assert tnative.available()
    A, _ = jsio.load_csr(MATRIX / "mat364.sms", 257)
    B, _ = tsio.load_csr(MATRIX / "mat364.sms", 257)
    for a, b in zip(j_pivots(A), t_pivots(B)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


CONSUMERS = ["rref", "kernel", "kernel_from_rref", "solve", "gesv",
             "rank_certificate_create", "rank_certificate_verify",
             "certificate_save", "certificate_load", "factorization_verify",
             "maximum_matching", "structural_rank", "dulmage_mendelsohn",
             "strongly_connected_components"]


@pytest.mark.parametrize("name", CONSUMERS)
def test_consumers_exported_with_jax_signatures(name):
    """Every consumer of a factorization that the JAX package exports has
    a counterpart of the same name and signature in the port's
    namespace."""
    assert name in spasm_tpu_torch.__all__
    assert (inspect.signature(getattr(spasm_tpu_torch, name))
            == inspect.signature(getattr(spasm_tpu, name)))
