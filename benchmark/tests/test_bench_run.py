"""Whole runs of the harness on the CPU (the look for a card skipped),
at tiny sizes: the result line's schema, the checks, every planted fault
and the lower-precision control coming out not correct, and new mixes
and metrics found by name."""
import json
import sys
import time

import pytest

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, capsys, *argv, device="cpu"):
    rc = harness.main(list(argv), time.time(), root=root,
                      data=root / "benchmark", device=device)
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), cap.err


def cell_args(workload, seed=2147483659, trace=0, *extra):
    return ["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
            "--trace", str(trace), *extra]


@pytest.mark.parametrize("workload", ["mk.rank", "tref.pluq"])
def test_cell_is_correct_and_well_formed(tiny_root, capsys, workload):
    rc, res, err = run(tiny_root, capsys, *cell_args(workload))
    assert rc == 0 and res["correct"] is True
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"call_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["unit"] == "s" and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # each compared number beside its limit, last on standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert c["limit"] == 0 and c["value"] == 0
        assert line == f"check {name}: {c['value']} (limit {c['limit']})"


@pytest.mark.parametrize("workload", ["mk.rank", "tref.pluq"])
def test_traced_run(tiny_root, capsys, workload):
    rc, res, _ = run(tiny_root, capsys, *cell_args(workload, 7, 1))
    assert rc == 0 and res["correct"] is True
    assert res["attempted"] == 2
    assert "call_s" not in res["metrics"]
    assert res["metrics"]["host.pivots_s"]["unit"] == "s"
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


# (workload, fault): every fault each cell can have
FAULTS = [(w, f) for w in ("mk.rank", "tref.pluq")
          for f in ("stale", "alter", "drop", "half", "bf16")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(tiny_root, capsys, workload, fault, monkeypatch):
    from spasm_tpu_torch.dense import modp
    monkeypatch.setattr(modp, "_mm8", modp._mm8)     # bf16 patches it
    rc, res, err = run(tiny_root, capsys,
                       *cell_args(workload, 11, 0, "--fault", fault))
    assert rc == 0 and res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


# an operation with neither launch nor plant: the warm-up and the traced
# run's replay make whole calls
NULLITY = """
from benchmark import echelon


def call(prog, torch, A, opts, dev):
    fact = prog.echelonize(A, opts, device=dev)
    return {"nullity": A.m - fact.r}, {"calls": 1.0}


def check(cell, inputs, kept, dev, torch):
    r = echelon.reference_rank(cell, inputs, dev, torch)
    return [{"nullity_gap": abs(out["nullity"] - (inputs.m - r))}
            for out in kept.values()]
"""


def test_new_mix_and_metric_found_by_name(tiny_root, capsys):
    bench = tiny_root / "benchmark"
    mix = json.loads((bench / "mixes" / "rank.tiny.json").read_text())
    (bench / "mixes" / "rank.tiny2.json").write_text(
        json.dumps(dict(mix, name="rank.tiny2")))
    (bench / "metrics" / "host.calls_seen.py").write_text(
        "def read(rec):\n    return float(rec['ncalls'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mk.rank2", "config": "mk9.b3",
                              "traffic": "rank.tiny2", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "host.calls_seen", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "host prep", "moves": "call_s",
                              "workloads": ["mk.rank2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        rc, res, _ = run(tiny_root, capsys, *cell_args("mk.rank2", 5, 1))
        assert rc == 0 and res["correct"] is True
        assert res["metrics"]["host.calls_seen"] == {"value": 2.0,
                                                    "unit": "calls"}
        assert "rank_finisher.span_s" not in res["metrics"]
    finally:
        spec["workloads"].pop()
        spec["per_layer"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_no_card_no_result(tiny_root, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, res, err = run(tiny_root, capsys, *cell_args("mk.rank"),
                       device=None)
    assert rc != 0 and res is None and "no card" in err


def test_forbidden_module_no_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "spasm_tpu.dense", object())
    rc, res, err = run(tiny_root, capsys, *cell_args("mk.rank"))
    assert rc == 3 and res is None and "spasm_tpu" in err


def test_forbidden_names_compare_whole():
    # the port's name begins with the JAX package's and is not it
    assert "spasm_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "jax" in harness.FORBIDDEN and "spasm_tpu" in harness.FORBIDDEN


def test_new_operation_found_by_name(tiny_root, capsys):
    bench = tiny_root / "benchmark"
    mix = json.loads((bench / "mixes" / "rank.tiny.json").read_text())
    (bench / "operations" / "nullity.py").write_text(NULLITY)
    (bench / "mixes" / "nullity.tiny.json").write_text(
        json.dumps(dict(mix, name="nullity.tiny", operation="nullity")))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mk.nullity", "config": "mk9.b3",
                              "traffic": "nullity.tiny", "chips": 1,
                              "why": "test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        for trace in (0, 1):
            rc, res, _ = run(tiny_root, capsys,
                             *cell_args("mk.nullity", 9, trace))
            assert rc == 0 and res["correct"] is True
            assert res["checks"] == {"nullity_gap": {"value": 0,
                                                     "limit": 0}}
        # the sound answer altered where it is made comes out not correct
        (bench / "operations" / "nullity.py").write_text(
            NULLITY.replace("A.m - fact.r}", "A.m - fact.r + 1}"))
        rc, res, _ = run(tiny_root, capsys, *cell_args("mk.nullity", 9))
        assert rc == 0 and res["correct"] is False
    finally:
        spec["workloads"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
