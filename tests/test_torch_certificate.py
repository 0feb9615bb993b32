"""Rank certificates: the port's `rank_certificate_create` / `_verify`,
`certificate_save` / `_load` (spasm_tpu_torch/certificate.py) against the
JAX package's on the same inputs, tolerance 0, on
tests/test_lu_solve.py's certificate fixtures at every modulus of
tests/torch_parity.py: the same fields and the same bytes, on the port's
and on the carried JAX factorization; certificates written by either
package verify under the other's `check_cert`."""
import functools
import io

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import certificate_save as jcertificate_save
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import rank_certificate_create as jrank_certificate_create
from spasm_tpu import rank_certificate_verify as jrank_certificate_verify
from spasm_tpu import sio as jsio
from spasm_tpu.cli import check_cert as jcheck_cert
from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.field import Field as JField

from spasm_tpu_torch import (EchelonizeOptions, certificate_load,
                             certificate_save, echelonize,
                             rank_certificate_create,
                             rank_certificate_verify, sio)
from spasm_tpu_torch.cli import check_cert
from tests.torch_parity import MATRIX, MODULI, carried

torch.set_num_threads(2)

CERT = ["singular.sms", "small.sms", "G2.sms"]
FIELDS = ("r", "prime", "hash", "i", "j", "x", "y")


@functools.lru_cache(maxsize=None)
def _pluq(name, p):
    """(port A, its hash, JAX complete PLUQ, port complete PLUQ)."""
    J, hj = jsio.load_csr(MATRIX / name, p, want_hash=True)
    A, h = sio.load_csr(MATRIX / name, p, want_hash=True)
    assert h == hj
    j = jechelonize(J, JOpts(complete=True))
    t = echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    return A, h, j, t


def _saved(save, proof) -> str:
    buf = io.StringIO()
    save(proof, buf)
    return buf.getvalue()


def _same_fields(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", CERT)
def test_rank_certificate_matches_jax(name, p):
    """Every field and the saved bytes equal the JAX package's, on the
    port's and on the carried factorization."""
    A, h, j, t = _pluq(name, p)
    want = jrank_certificate_create(
        jsio.load_csr(MATRIX / name, p)[0], h, j)
    for fact in (t, carried(j)):
        proof = rank_certificate_create(A, h, fact)
        assert _same_fields(proof, want)
        assert _saved(certificate_save, proof) == _saved(jcertificate_save,
                                                         want)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", CERT)
def test_rank_certificate_roundtrip(name, p):
    """tests/test_lu_solve.py:test_rank_certificate_roundtrip on the port:
    create + verify, a tampered hash fails, save / load gives back every
    field (j included: the reference's load never fills it), and a copy
    of A with one entry changed gets the JAX package's verdict: false
    but over GF(3), where the two random checks miss a change with
    probability about 1/3."""
    A, h, _, t = _pluq(name, p)
    proof = rank_certificate_create(A, h, t)
    assert proof.r == t.r
    assert rank_certificate_verify(A, h, proof)
    bad = bytearray(h)
    bad[0] ^= 1
    assert not rank_certificate_verify(A, bytes(bad), proof)
    back = certificate_load(io.StringIO(_saved(certificate_save, proof)))
    assert back is not None and _same_fields(back, proof)
    assert rank_certificate_verify(A, h, back)
    B = A.copy()
    B.data[0] = A.field.normalize(int(B.data[0]) + 1)
    JB = JCSR(B.n, B.m, JField(p), B.indptr, B.indices, B.data)
    verdict = rank_certificate_verify(B, h, proof)
    assert verdict == jrank_certificate_verify(JB, h, proof)
    assert p == 3 or not verdict


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", CERT)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_certificates_interoperate(name, p, writer, tmp_path, capsys):
    """A certificate saved by one package passes the other's and its own
    check_cert (exit 0, "CORRECT certificate"); on another matrix both
    refuse it (exit 1)."""
    A, h, j, t = _pluq(name, p)
    cert = tmp_path / "cert.txt"
    if writer == "jax":
        jcertificate_save(jrank_certificate_create(
            jsio.load_csr(MATRIX / name, p)[0], h, j), str(cert))
    else:
        certificate_save(rank_certificate_create(A, h, t), str(cert))
    other = "t1.sms"                     # not among CERT
    for tool in (check_cert, jcheck_cert):
        argv = ["--modulus", str(p), "-c", str(cert), "--matrix"]
        assert tool.main(argv + [str(MATRIX / name)]) == 0
        assert "CORRECT certificate" in capsys.readouterr().err
        assert tool.main(argv + [str(MATRIX / other)]) == 1
        assert "INCORRECT certificate" in capsys.readouterr().err


@pytest.mark.parametrize("text", ["", "3\n257\nzz\n", "2\n257\n" + "00" * 32
                                  + "\n0 1 \n0 \n1 1 \n1 1 \n"])
def test_certificate_load_refuses_malformed(text):
    """certificate_load returns None on a truncated file, a bad hash and
    an array of the wrong length, as the JAX package's does."""
    assert certificate_load(io.StringIO(text)) is None
