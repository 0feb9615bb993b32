"""Matchings, strongly connected components and the Dulmage-Mendelsohn
decomposition: the port (spasm_tpu_torch/{matching,dm}.py) against the
JAX package on the same inputs, tolerance 0, on tests/test_graph.py's
fixtures at every modulus of tests/torch_parity.py (the modulus drops
entries divisible by it, so the pattern changes at 3), plus the cases of
tests/test_graph.py on the port.  The native matching and the
pure-Python one are held to each other."""
import functools

import numpy as np
import pytest

from spasm_tpu import dulmage_mendelsohn as jdulmage_mendelsohn
from spasm_tpu import maximum_matching as jmaximum_matching
from spasm_tpu import sio as jsio
from spasm_tpu import strongly_connected_components as jscc
from spasm_tpu import structural_rank as jstructural_rank
from spasm_tpu import matching as jmatching
from spasm_tpu.csr import pinv as jpinv

from spasm_tpu_torch import (dulmage_mendelsohn, maximum_matching, native,
                             sio, strongly_connected_components,
                             structural_rank)
from spasm_tpu_torch import matching
from spasm_tpu_torch.csr import pinv as make_pinv
from spasm_tpu_torch.csr import random_permutation
from tests.test_dense import np_rank
from tests.test_graph import DM_MATRICES
from tests.torch_parity import MATRIX, MODULI

SCC_MATRICES = ["scc.sms", "scc2.sms", "scc3.sms"]
DM_FIELDS = ("p", "q", "r", "c", "nb", "rr", "cc")


@functools.lru_cache(maxsize=None)
def _load(name, p):
    return (jsio.load_csr(MATRIX / name, p)[0],
            sio.load_csr(MATRIX / name, p)[0])


def _same_dm(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in DM_FIELDS)


def _permuted(J, A):
    """Both sides after tests/test_graph.py's random pre-permutation."""
    rng = np.random.default_rng(3)
    p0 = random_permutation(A.n, rng)
    q0 = random_permutation(A.m, rng)
    return (J.permute(p0, jpinv(q0, A.m)), A.permute(p0, make_pinv(q0, A.m)))


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", DM_MATRICES)
def test_matching_matches_jax(name, p, monkeypatch):
    """(size, jmatch, imatch) bit-equal to the JAX package's, on A and
    on its transpose, in the native and the pure-Python branch."""
    J, A = _load(name, p)
    want = [jmaximum_matching(M) for M in (J, J.transpose(False))]
    got = [maximum_matching(M) for M in (A, A.transpose(False))]
    assert native.available()
    monkeypatch.setattr(native, "available", lambda: False)
    py = [maximum_matching(M) for M in (A, A.transpose(False))]
    for w, g, q in zip(want, got, py):
        for a, b, c in zip(w, g, q):
            assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", DM_MATRICES)
def test_dm_matches_jax(name, p):
    """DM (p, q, r, c, nb, rr, cc) and structural rank bit-equal to the
    JAX package's, on A and after a random pre-permutation."""
    J, A = _load(name, p)
    assert structural_rank(A) == jstructural_rank(J)
    for JJ, AA in ((J, A), _permuted(J, A)):
        assert _same_dm(dulmage_mendelsohn(AA), jdulmage_mendelsohn(JJ))


@pytest.mark.parametrize("name", SCC_MATRICES)
def test_scc_matches_jax(name):
    J, A = _load(name, 257)
    assert _same_dm(strongly_connected_components(A), jscc(J))


@pytest.mark.parametrize("name", DM_MATRICES)
def test_matching_permutations_match_jax(name):
    """permute_row_matching, permute_column_matching and submatching on
    a matching and the DM permutations, as the JAX package's."""
    J, A = _load(name, 257)
    _, jm, im = maximum_matching(A)
    D = dulmage_mendelsohn(A)
    qinv, pinv = make_pinv(D.q, A.m), make_pinv(D.p, A.n)
    pairs = [
        (matching.permute_row_matching(A.n, jm, D.p, qinv),
         jmatching.permute_row_matching(A.n, jm, D.p, qinv)),
        (matching.permute_column_matching(A.m, im, pinv, D.q),
         jmatching.permute_column_matching(A.m, im, pinv, D.q)),
        (matching.submatching(jm, 0, A.n // 2, 1),
         jmatching.submatching(jm, 0, A.n // 2, 1))]
    for got, want in pairs:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", DM_MATRICES)
def test_matching_valid(name):
    """tests/test_graph.py:test_matching_valid on the port."""
    _, A = _load(name, 257)
    size, jmatch, imatch = maximum_matching(A)
    cnt = 0
    for i in range(A.n):
        j = jmatch[i]
        if j >= 0:
            assert imatch[j] == i
            assert np.any(A.row(i)[0] == j)
            cnt += 1
    assert cnt == size
    assert size >= np_rank(A.todense(), 257) or A.n > A.m


@pytest.mark.parametrize("name", DM_MATRICES)
def test_structural_rank_bounds(name):
    _, A = _load(name, 257)
    sr = structural_rank(A)
    assert np_rank(A.todense(), 257) <= sr <= min(A.n, A.m)


@pytest.mark.parametrize("name", SCC_MATRICES)
def test_scc_blocks(name):
    """tests/test_graph.py:test_scc_blocks on the port."""
    _, A = _load(name, 257)
    assert A.n == A.m
    P = strongly_connected_components(A)
    assert sorted(P.p.tolist()) == list(range(A.n))
    D = A.todense()[P.p][:, P.p] != 0
    for b in range(P.nb):
        lo, hi = P.r[b], P.r[b + 1]
        assert not np.any(D[hi:, lo:hi]), "entry below SCC diagonal block"


@pytest.mark.parametrize("name", DM_MATRICES)
def test_dm_properties(name):
    """tests/test_graph.py:test_dm_properties on the port."""
    _, A = _permuted(*_load(name, 257))
    DM = dulmage_mendelsohn(A)
    n, m = A.n, A.m
    assert sorted(DM.p.tolist()) == list(range(n))
    assert sorted(DM.q.tolist()) == list(range(m))
    rr, cc = DM.rr, DM.cc
    assert rr[0] == 0 and rr[4] == n
    assert cc[0] == 0 and cc[4] == m
    D = A.todense()[DM.p][:, DM.q] != 0
    assert not np.any(D[rr[1]:rr[2], :cc[2]])
    assert not np.any(D[rr[2]:, :cc[3]])
    assert rr[2] - rr[1] == cc[3] - cc[2]


def test_dm_empty_and_square():
    J, A = _load("void.sms", 257)
    DM = dulmage_mendelsohn(A)
    assert sorted(DM.p.tolist()) == list(range(A.n))
    assert _same_dm(DM, jdulmage_mendelsohn(J))
