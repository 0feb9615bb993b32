"""The engine's `spasm/...` profiler ranges (profiling.phase / annotate):
where the factors are read, inside the rank finisher, around the digit
matmul; and none at all when no profiler is active."""
import re

import numpy as np
import pytest
import torch

from spasm_tpu_torch import CSR, EchelonizeOptions, echelonize, profiling

P = 42013
FACTORS = {"spasm/factors_u": ("spasm/u_copy", "spasm/u_sparsify",
                               "spasm/u_levels", "spasm/u_concat"),
           "spasm/factors_l": ("spasm/l_copy", "spasm/l_sparsify",
                               "spasm/l_csr")}
RANK_FINISHER = ("spasm/flat_store", "spasm/reduced_basis",
                 "spasm/form_block", "spasm/basis_apply", "spasm/rref_rows",
                 "spasm/pivcol_wait", "spasm/basis_add", "spasm/completion",
                 "spasm/basis_register", "spasm/matmul_digits")


def _dense_square():
    """300 x 300 at density 0.3: few structural pivots, so a complete
    PLUQ sends a block of >= 2^16 elements to the device LU."""
    rng = np.random.default_rng(3)
    D = np.where(rng.random((300, 300)) < 0.3,
                 rng.integers(1, P, (300, 300)), 0)
    return CSR.from_dense(D, P)


def _tall_lowrank():
    """test_torch_echelonize's low-rank fixture with a denser right
    factor: rank <= 40 under 1500 rows, fewer structural pivots than
    that, so the rank finisher runs in lowrank mode, adds pivot rows to
    its basis and stops at its completion test."""
    rng = np.random.default_rng(5)
    C = np.where(rng.random((1500, 40)) < 0.08,
                 rng.integers(1, P, (1500, 40)), 0)
    B = np.where(rng.random((40, 200)) < 0.3,
                 rng.integers(1, P, (40, 200)), 0)
    return CSR.from_dense((C @ B) % P, P)


def _spans(fn):
    """{name: [(thread, start_ns, end_ns)]} of the spasm/ ranges that
    fn() entered under a CPU profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("spasm/"):
            s = e.start_ns()
            out.setdefault(e.name(), []).append(
                (e.start_thread_id(), s, s + e.duration_ns()))
    return out


def _inside(child, parents) -> bool:
    t, s, e = child
    return any(t == pt and ps <= s and e <= pe for pt, ps, pe in parents)


def test_factors_spans_nest_in_the_read(caplog):
    A = _dense_square()
    fact = echelonize(A, EchelonizeOptions(complete=True), device="cpu")

    def read():
        assert fact.U.n == fact.r and fact.L.n == A.n

    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        spans = _spans(read)
    # L's engagement record: the device LU's blocks, and one host entry
    # per structural pivot
    m = re.search(r"L's CSR built on cpu: (\d+) entries from device "
                  r"blocks, (\d+) from host batches", caplog.text)
    assert m and int(m[1]) > 0
    assert int(m[2]) == sum(r["pivots"] for r in fact.rounds) > 0
    for parent, children in FACTORS.items():
        assert len(spans.get(parent, [])) == 1, parent
        for child in children:
            assert any(_inside(c, spans[parent])
                       for c in spans.get(child, [])), (child, parent)
    # the copies happen only in the reads
    for child in ("spasm/u_copy", "spasm/l_copy", "spasm/l_csr"):
        assert all(_inside(c, spans["spasm/factors_u"]
                           + spans["spasm/factors_l"])
                   for c in spans[child]), child


def test_factors_read_is_the_device_lu_route():
    """The fixture above reaches the device LU (its U has a pending
    device segment, its L the thunks), so every child runs."""
    spans = _spans(lambda: echelonize(
        _dense_square(), EchelonizeOptions(complete=True), device="cpu"))
    assert "spasm/dense_lu" in spans and "spasm/compose_chunk" in spans
    assert all(_inside(c, spans["spasm/dense_lu"])
               for c in spans["spasm/pivmap_read"])


@pytest.mark.parametrize("rref", [True, False])
def test_block_update_spans(rref):
    """_eliminate over four 64-column blocks: three trailing inverses and
    three block updates, each update holding its two digit products."""
    from spasm_tpu_torch.dense import elim
    gen = torch.Generator().manual_seed(7)
    X = torch.randint(-P // 2, P // 2 + 1, (96, 256), generator=gen,
                      dtype=torch.int32)
    spans = _spans(lambda: elim._eliminate(elim._pad(X, 64), P, rref, 64,
                                           nblk=64))
    assert len(spans["spasm/trailing_inverse"]) == 3
    assert len(spans["spasm/trailing_update"]) == 3
    inner = [c for c in spans["spasm/matmul_digits"]
             if _inside(c, spans["spasm/trailing_update"])]
    assert len(inner) == 6


def test_rank_finisher_stage_spans():
    A = _tall_lowrank()
    spans = _spans(lambda: echelonize(
        A, EchelonizeOptions(device_dense_min=0), device="cpu").U)
    assert len(spans["spasm/finish_device"]) == 1
    for name in RANK_FINISHER:
        assert spans.get(name), name
        assert all(_inside(c, spans["spasm/finish_device"])
                   for c in spans[name]), name
    # U is read after the finisher: flat_store's children run in both
    assert any(_inside(c, spans["spasm/finish_device"])
               for c in spans["spasm/u_concat"])
    assert any(_inside(c, spans["spasm/factors_u"])
               for c in spans["spasm/u_copy"])


def _raise(*a, **kw):
    raise AssertionError("record_function entered without a profiler")


def test_phase_off_means_off(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    with profiling.phase("nothing"):
        pass
    fact = echelonize(_tall_lowrank(), EchelonizeOptions(device_dense_min=0),
                      device="cpu")
    assert fact.U.n == fact.r
    fact = echelonize(_dense_square(), EchelonizeOptions(complete=True),
                      device="cpu")
    assert fact.L.n == 300
    # the same patch is what phase() enters under a profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="without a profiler"):
            with profiling.phase("something"):
                pass
