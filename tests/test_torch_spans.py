"""The engine's `spasm/...` profiler ranges (profiling.phase / annotate):
where the factors are read, inside the rank finisher, around the digit
matmul, around each round, each wide row sweep and each block forming's
combine, with the benchmark's readers of the last three; and none at
all when no profiler is active."""
import re

import numpy as np
import pytest
import torch

from benchmark import harness, tracing
from spasm_tpu_torch import (CSR, EchelonizeOptions, Field, echelonize,
                             profiling)
from spasm_tpu_torch.gen import matching_complex_boundary

P = 42013
# U's read computes no levels: `u_levels` runs only where flat_store's
# groups are built for the reduced basis
FACTORS = {"spasm/factors_u": ("spasm/u_copy", "spasm/u_sparsify",
                               "spasm/u_concat"),
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


def _span_map(events):
    """{name: [(thread, start_ns, end_ns)]} of the spasm/ ranges among
    raw profiler events (the host's: a profile of the card's activity
    also holds each range's mirror on the device's timeline)."""
    from torch.autograd import DeviceType
    out = {}
    for e in events:
        if (e.name().startswith("spasm/")
                and e.device_type() != DeviceType.CUDA):
            s = e.start_ns()
            out.setdefault(e.name(), []).append(
                (e.start_thread_id(), s, s + e.duration_ns()))
    return out


def _spans(fn):
    """The spasm/ ranges that fn() entered under a CPU profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return _span_map(prof.profiler.kineto_results.events())


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
    assert not any(_inside(c, spans["spasm/factors_u"])
                   for c in spans.get("spasm/u_levels", []))
    # U's: the last read, with the device LU's rows
    m = re.findall(r"U read: (\d+) entries from device blocks \(sparsified "
                   r"on cpu\), (\d+) from host segments; levels of 0 rows",
                   caplog.text)
    assert m and int(m[-1][0]) > 0 and int(m[-1][1]) > 0
    # the copies happen only in the reads
    for child in ("spasm/u_copy", "spasm/l_copy", "spasm/l_csr"):
        assert all(_inside(c, spans["spasm/factors_u"]
                           + spans["spasm/factors_l"])
                   for c in spans[child]), child


def test_u_levels_run_where_groups_are_built(tmp_path, monkeypatch):
    """A call resumed from its checkpoint holds U's earlier rows as one
    segment without levels: the rank finisher's flat_store computes them
    for the reduced basis, inside its `flat_store` range, and the read
    of U after it computes none."""
    from spasm_tpu_torch import checkpoint as ckpt
    A = _tall_lowrank()
    opts = EchelonizeOptions(device_dense_min=0,
                             checkpoint_file=str(tmp_path / "ck.npz"))
    real = ckpt.save_checkpoint

    def save_then_stop(path, **kw):
        real(path, **kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save_checkpoint", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        echelonize(A, opts, device="cpu")
    monkeypatch.setattr(ckpt, "save_checkpoint", real)
    spans = _spans(lambda: echelonize(A, opts, device="cpu").U)
    levels = spans["spasm/u_levels"]
    assert levels and all(_inside(c, spans["spasm/flat_store"])
                          for c in levels)
    assert all(_inside(c, spans["spasm/finish_device"])
               for c in spans["spasm/flat_store"])
    assert len(spans["spasm/factors_u"]) == 1
    assert not any(_inside(c, spans["spasm/factors_u"]) for c in levels)


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


# the cells mk12b4.rank and mk12b4.rank.p4294967291: their readers and
# the ranges they read
NEW_READERS = ("rounds.span_s", "step_sweep.device_s", "step_sweep.launches",
               "rank_finisher.rows_blocks")
PW = 4294967291


def _read(name, rec):
    return harness.load_module(harness.BENCH / "metrics"
                               / f"{name}.py").read(rec)


def _record(fn, card=False):
    """The benchmark's traced record (benchmark/tracing.py) of one call
    of fn() under a CPU profiler (with `card`, the card's activity too),
    and its spasm/ spans as _spans gives them."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench/call"):
            fn()
    events = prof.profiler.kineto_results.events()
    rec = tracing.record_of(events)
    rec["ncalls"] = 1
    return rec, _span_map(events)


@pytest.fixture(scope="module")
def wide_route():
    """mk10.b3 at 2^32 - 5 on mk12.b4's route there: round 0 forms its
    sparse Schur complement through the reduced basis (the width cap,
    600 free columns at d = 4, below round 0's 637), round 1 hands the
    rank finisher its 589 free columns in rows mode, whose sub-panels
    take step_sweep."""
    B = matching_complex_boundary(10, 3)
    A = CSR(B.n, B.m, Field(PW), B.indptr, B.indices, B.data)
    opts = EchelonizeOptions(device_dense_min=0, device_dense_width=2400)
    out = {}
    out["rec"], out["spans"] = _record(
        lambda: out.setdefault("fact", echelonize(A, opts, device="cpu")))
    return out


def test_round_spans_hold_pivots_and_schur(wide_route):
    spans, fact = wide_route["spans"], wide_route["fact"]
    assert fact.r == 2564 and "schur_nnz" in fact.rounds[0]
    rounds = spans["spasm/round"]
    assert len(rounds) == len(fact.rounds) == 2
    for name in ("spasm/pivots", "spasm/density_estimate",
                 "spasm/schur_sparse"):
        assert spans[name] and all(_inside(c, rounds)
                                   for c in spans[name]), name
    # round 0 holds the Schur complement, round 1 only its pivots
    assert all(_inside(c, rounds[:1]) for c in spans["spasm/schur_sparse"])
    assert any(_inside(c, rounds[1:]) for c in spans["spasm/pivots"])
    # the finisher runs after the rounds, outside them
    assert not any(_inside(c, rounds) for c in spans["spasm/finish_device"])


def test_step_sweep_spans_sit_inside_rref_rows(wide_route):
    spans = wide_route["spans"]
    sweeps = spans["spasm/step_sweep"]
    assert sweeps and all(_inside(c, spans["spasm/rref_rows"])
                          for c in sweeps)
    assert all(_inside(c, spans["spasm/finish_device"])
               for c in spans["spasm/rref_rows"])
    # one sweep a 64-row sub-panel of every block swept
    assert len(sweeps) % 16 == 0 and len(sweeps) >= 16


def test_new_readers_on_the_wide_route(wide_route):
    rec, spans = wide_route["rec"], wide_route["spans"]
    got = {name: _read(name, rec) for name in NEW_READERS}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["rank_finisher.rows_blocks"] == len(spans["spasm/rref_rows"])
    assert 0 < got["rounds.span_s"] <= (rec["calls"][0][1]
                                        - rec["calls"][0][0]) / 1e6
    # no device here: nothing launched, no device time
    assert got["step_sweep.launches"] == got["step_sweep.device_s"] == 0.0


def test_new_readers_none_where_the_span_is_absent():
    """At 42013 no step_sweep runs; an empty record holds no range."""
    rec, spans = _record(lambda: echelonize(
        _tall_lowrank(), EchelonizeOptions(device_dense_min=0),
        device="cpu"))
    assert "spasm/step_sweep" not in spans
    assert _read("step_sweep.device_s", rec) is None
    assert _read("step_sweep.launches", rec) is None
    assert _read("rounds.span_s", rec) > 0
    assert _read("rank_finisher.rows_blocks", rec) == len(
        spans["spasm/rref_rows"])
    empty = tracing.record_of([])
    empty["ncalls"] = 0
    for name in NEW_READERS:
        assert _read(name, empty) is None, name


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


COMBINE_READERS = ("ref_combine.device_s", "ref_combine.launches")


@pytest.mark.parametrize("p", [P, PW])
def test_ref_combine_spans_sit_inside_form_block(p, request):
    """Every chunk's combine runs in a `spasm/ref_combine` range: inside
    the finisher's `form_block` at 42013 (low-rank mode) and at 2^32 - 5
    (rows mode), where round 0 forms its Schur complement's blocks
    inside `schur_sparse` too; on the CPU its readers read 0."""
    if p == PW:
        rec, spans = (request.getfixturevalue("wide_route")[k]
                      for k in ("rec", "spans"))
        parents = spans["spasm/form_block"] + spans["spasm/schur_sparse"]
        assert any(_inside(c, spans["spasm/schur_sparse"])
                   for c in spans["spasm/ref_combine"])
    else:
        rec, spans = _record(lambda: echelonize(
            _tall_lowrank(), EchelonizeOptions(device_dense_min=0),
            device="cpu"))
        parents = spans["spasm/form_block"]
    combines = spans["spasm/ref_combine"]
    assert combines and all(_inside(c, parents) for c in combines)
    assert any(_inside(c, spans["spasm/form_block"]) for c in combines)
    got = {name: _read(name, rec) for name in COMBINE_READERS}
    assert got == {name: 0.0 for name in COMBINE_READERS}


def test_ref_combine_readers_none_without_the_range():
    """A complete PLUQ through the dense finisher forms no block: no
    `spasm/ref_combine` range, and its readers return None there and on
    an empty record."""
    rec, spans = _record(lambda: echelonize(
        _dense_square(), EchelonizeOptions(complete=True), device="cpu"))
    assert "spasm/ref_combine" not in spans and "spasm/finish_dense" in spans
    empty = tracing.record_of([])
    empty["ncalls"] = 0
    for name in COMBINE_READERS:
        assert _read(name, rec) is None, name
        assert _read(name, empty) is None, name


# the cell trefethen20kb.pluq.p4294967291: the d >= 3 dense LU's panels
PANEL_READERS = ("panel_steps.device_s", "panel_steps.launches")


def _panels_counted(monkeypatch):
    """Counts the panel steps of every `_eliminate` (elim._panel_step)."""
    from spasm_tpu_torch.dense import elim
    seen = []
    real = elim._panel_step

    def count(*a, **kw):
        seen.append(a[1])
        return real(*a, **kw)

    monkeypatch.setattr(elim, "_panel_step", count)
    return seen


def _wide_square():
    """_dense_square's matrix at 2^32 - 5: its dense LU (271 x 271,
    padded to 512 columns) takes panel_steps, the d >= 3 route."""
    A = _dense_square()
    return CSR(A.n, A.m, Field(PW), A.indptr, A.indices, A.data)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_panel_steps_spans_sit_inside_finish_dense(device, monkeypatch):
    if device == "cuda":
        _card()
    panels = _panels_counted(monkeypatch)
    rec, spans = _record(lambda: echelonize(
        _wide_square(), EchelonizeOptions(complete=True), device=device),
        card=device == "cuda")
    steps = spans["spasm/panel_steps"]
    # one range a panel, each inside the dense LU inside the finisher
    assert len(panels) == len(steps) == 8
    assert all(_inside(c, spans["spasm/dense_lu"]) for c in steps)
    assert all(_inside(c, spans["spasm/finish_dense"]) for c in steps)
    got = {name: _read(name, rec) for name in PANEL_READERS}
    if device == "cpu":      # nothing launched, no device time
        assert got == {name: 0.0 for name in PANEL_READERS}
    else:
        assert all(v > 0 for v in got.values()), got


def test_panel_readers_none_without_the_range():
    """The rank finisher in low-rank mode runs no dense LU; an empty
    record holds no range."""
    rec, spans = _record(lambda: echelonize(
        _tall_lowrank(), EchelonizeOptions(device_dense_min=0),
        device="cpu"))
    assert "spasm/panel_steps" not in spans
    empty = tracing.record_of([])
    empty["ncalls"] = 0
    for name in PANEL_READERS:
        assert _read(name, rec) is None, name
        assert _read(name, empty) is None, name


@pytest.mark.cuda
def test_no_panel_steps_at_42013_on_the_card(monkeypatch):
    """On the card the d = 2 tier's panels are kernel B4's: a complete
    PLUQ at 42013 enters no `spasm/panel_steps` range."""
    _card()
    panels = _panels_counted(monkeypatch)
    rec, spans = _record(lambda: echelonize(
        _dense_square(), EchelonizeOptions(complete=True), device="cuda"))
    assert len(panels) == 8 and spans["spasm/dense_lu"]
    assert "spasm/panel_steps" not in spans
    for name in PANEL_READERS:
        assert _read(name, rec) is None, name
