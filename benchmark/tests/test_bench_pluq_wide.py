"""Trefethen_20000b's configuration and its cell at tiny size on the CPU:
the configuration file against its generator, and whole runs of the
tiny stand-in (benchmark/tests/pluq_wide/conftest.py) of
`trefethen20kb.pluq.p4294967291` (the `pluq_wide` operation at
2^32 - 5): correct, the panel_steps readers read, and every planted
fault and the lower-precision control not correct."""
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import reference_wide_lu as wide
from test_bench_run import cell_args, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
PW = 4294967291
CELL = "tref.pluq_wide"
METRICS = {"panel_steps.device_s", "panel_steps.launches"}


def _gen(name):
    return harness.load_module(ROOT / "benchmark" / "matrices"
                               / f"{name}.py")


def test_config_equals_generator():
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "trefethen_20000b.json").read_text())
    assert (conf["generator"], conf["args"]) == ("trefethen_minor",
                                                 {"n": 20000})
    n, m, indptr, indices, values = _gen("trefethen_minor").generate(20000)
    assert [n, m] == conf["shape"] == [19999, 19999]
    assert int(indptr[-1]) == conf["nnz"] == 554435
    # the (1, 1) minor of the generator that trefethen20k.pluq runs
    _, _, ip, ix, v = _gen("trefethen").generate(20000)
    rows = np.repeat(np.arange(20000), np.diff(ip))
    keep = (rows > 0) & (ix > 0)
    assert int(keep.size - keep.sum()) == 31        # row and column 1
    assert np.array_equal(np.repeat(np.arange(n), np.diff(indptr)),
                          rows[keep] - 1)
    assert np.array_equal(indices, ix[keep] - 1)
    assert np.array_equal(values, v[keep])
    assert conf["ranks"] == {str(PW): 19999} and conf["reduced"] == []
    mix = json.loads((ROOT / "benchmark" / "mixes" / "pluq.p4294967291.json")
                     .read_text())
    assert (mix["operation"], mix["prime"], mix["options"]) == \
        ("pluq_wide", PW, {"complete": True})
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[
        "trefethen20kb.pluq.p4294967291"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("trefethen_20000b", "pluq.p4294967291", 1)


@pytest.fixture(scope="module")
def wide_lu_root(tiny_root):
    """The tiny root with the stand-in's rank at 2^32 - 5, by exact
    elimination of the minor (reference_wide_lu.dense_rank)."""
    bench = tiny_root / "benchmark"
    cell = harness.Cell(CELL, tiny_root, bench)
    n, m, indptr, indices, values = cell.matrix()
    D = torch.zeros((n, m), dtype=torch.int64)
    D[np.repeat(np.arange(n), np.diff(indptr)), indices] = torch.as_tensor(
        values)
    path = bench / "configs" / "tref600b.json"
    conf = json.loads(path.read_text())
    conf["ranks"] = {str(PW): wide.dense_rank(D, PW)}
    path.write_text(json.dumps(conf))
    return tiny_root


@pytest.mark.parametrize("trace", [0, 1])
def test_stand_in_is_correct(wide_lu_root, capsys, trace):
    rc, res, _ = run(wide_lu_root, capsys,
                     *cell_args(CELL, 2 ** 33 + 13, trace))
    assert rc == 0 and res["correct"] is True
    assert res["checks"] == {k: {"value": 0, "limit": 0} for k in
                             ("rank_gap", "echelon_faults", "l_faults",
                              "lu_residual")}
    if trace:
        assert METRICS <= set(res["metrics"])
        assert res["metrics"]["panel_steps.launches"]["unit"] == "launches"
        # CPU tensors: the ranges are there, no kernel in them
        assert res["metrics"]["panel_steps.launches"]["value"] == 0
        assert res["metrics"]["panel_steps.device_s"]["value"] == 0
    else:
        assert set(res["metrics"]) == {"call_s", "setup_s"}


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_fault_is_not_correct(wide_lu_root, capsys, fault, monkeypatch):
    from spasm_tpu_torch.dense import modp
    monkeypatch.setattr(modp, "_mm8", modp._mm8)     # bf16 patches it
    rc, res, _ = run(wide_lu_root, capsys,
                     *cell_args(CELL, 19, 0, "--fault", fault))
    assert rc == 0 and res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
