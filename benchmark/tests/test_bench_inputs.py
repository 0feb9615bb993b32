"""The frozen generators give the published matrices, and the +-1
scalings keep each matrix's structure and |values|."""
import pathlib

import numpy as np
import pytest

from benchmark import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
MATRICES = ROOT / "benchmark" / "matrices"


def gen(name):
    return harness.load_module(MATRICES / f"{name}.py")


def test_mk13_b5_published_shape():
    n, m, indptr, indices, values = gen("matching_complex").generate(
        13, 5, transpose=True)
    assert (n, m, int(indptr[-1])) == (270270, 135135, 810810)
    assert set(np.unique(values)) == {-1, 1}


@pytest.mark.parametrize("n,j", [(6, 2), (8, 3), (9, 4)])
@pytest.mark.parametrize("transpose", [False, True])
def test_matching_complex_equals_program_generator(n, j, transpose):
    from spasm_tpu_torch.gen import matching_complex_boundary
    A = matching_complex_boundary(n, j)
    if transpose:
        A = A.transpose()
    got = gen("matching_complex").generate(n, j, transpose)
    assert (got[0], got[1]) == (A.n, A.m)
    for a, b in zip(got[2:], (A.indptr, A.indices, A.data)):
        assert np.array_equal(a, b)


def test_trefethen_20000_published_shape():
    n, m, indptr, indices, values = gen("trefethen").generate(20000)
    assert (n, m, int(indptr[-1])) == (20000, 20000, 554466)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    diag = rows == indices
    assert values[diag][:4].tolist() == [2, 3, 5, 7]
    assert int(values[diag][-1]) == 224737          # the 20000th prime
    off = np.abs(rows - indices)[~diag]
    assert ((off & (off - 1)) == 0).all() and (values[~diag] == 1).all()


def test_trefethen_2000_equals_the_fixture():
    n, m, indptr, indices, values = gen("trefethen").generate(2000)
    sms = np.loadtxt(ROOT / "tests" / "Matrix" / "trefethen_2000.sms",
                     skiprows=1, dtype=np.int64)
    sms = sms[sms[:, 0] > 0]
    sms = sms[np.lexsort((sms[:, 1], sms[:, 0]))]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert int(indptr[-1]) == len(sms) == 41906
    assert np.array_equal(sms[:, 0] - 1, rows)
    assert np.array_equal(sms[:, 1] - 1, indices)
    assert np.array_equal(sms[:, 2], values)


def test_zero_entries_mod_p_dropped(tiny_root):
    cell = harness.Cell("tref.pluq", tiny_root, tiny_root / "benchmark")
    n, m, indptr, indices, values = cell.matrix()
    assert (values != 0).all()
    assert np.abs(values).max() <= cell.prime // 2


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17, -5])
def test_scalings_keep_structure_and_abs_values(tiny_root, seed):
    cell = harness.Cell("mk.rank", tiny_root, tiny_root / "benchmark")
    base = cell.matrix()
    inputs = harness.Inputs(base, cell.prime, seed)
    d0, d1 = inputs.data(0), inputs.data(1)
    assert np.array_equal(np.abs(d0), np.abs(base[4]))
    assert not np.array_equal(d0, d1)                # a fresh input
    assert np.array_equal(d0, harness.Inputs(base, cell.prime,
                                             seed).data(0))
    # the signs are a row scaling times a column scaling: a search over
    # the bipartite graph of rows and columns finds no conflict
    s = (d0 * base[4]).astype(np.int64)          # base[4] is +-1 here
    adj = {}
    for k, (i, j) in enumerate(zip(inputs.rows.tolist(),
                                   base[3].tolist())):
        adj.setdefault(("r", i), []).append((("c", j), int(s[k])))
        adj.setdefault(("c", j), []).append((("r", i), int(s[k])))
    sign = {}
    for root in adj:
        if root in sign:
            continue
        sign[root], todo = 1, [root]
        while todo:
            u = todo.pop()
            for v, e in adj[u]:
                if v not in sign:
                    sign[v] = sign[u] * e
                    todo.append(v)
                assert sign[v] == sign[u] * e
