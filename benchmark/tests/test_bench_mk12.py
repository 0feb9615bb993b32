"""mk12.b4's configuration and its two cells at tiny size on the CPU:
the configuration file against the program's generator, and whole runs
of the tiny stand-ins (benchmark/conftest.py) of `mk12b4.rank` (rows
mode at 42013) and `mk12b4.rank.p4294967291` (the `rank_wide` operation
at 2^32 - 5): correct, their per-layer metrics read, and every planted
fault and the lower-precision control not correct."""
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import reference as ref
from test_bench_run import cell_args, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
PW = 4294967291
WIDE_METRICS = {"rounds.span_s", "step_sweep.device_s",
                "step_sweep.launches", "rank_finisher.rows_blocks"}


def test_config_equals_program_generator():
    from spasm_tpu_torch.gen import matching_complex_boundary
    conf = json.loads((ROOT / "benchmark" / "configs" / "mk12.b4.json")
                      .read_text())
    A = matching_complex_boundary(12, 4)
    assert [A.n, A.m] == conf["shape"] and A.nnz == conf["nnz"]
    assert conf["args"] == {"n": 12, "j": 4, "transpose": False}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {"mk12b4.rank", "mk12b4.rank.p4294967291"} <= {
        w["name"] for w in spec["workloads"] if w["config"] == "mk12.b4"}


@pytest.fixture(scope="module")
def wide_root(tiny_root):
    """The tiny root with the wide stand-in's mix (the rank finisher on
    a small block: device_dense_min 0) and mk9.b3's rank at 2^32 - 5,
    which is its dense rank at 42013 (tests/test_torch_mk12_config.py
    shows the two primes agree on these matrices)."""
    bench = tiny_root / "benchmark"
    mix = json.loads((bench / "mixes" / "rank.p4294967291.json").read_text())
    (bench / "mixes" / "rank_wide.tiny.json").write_text(json.dumps(
        dict(mix, name="rank_wide.tiny", options={"device_dense_min": 0})))
    path = bench / "configs" / "mk9.b3.json"
    conf = json.loads(path.read_text())
    cell = harness.Cell("mk.rank", tiny_root, bench)
    n, m, indptr, indices, values = cell.matrix()
    D = torch.zeros((n, m), dtype=torch.int64)
    D[np.repeat(np.arange(n), np.diff(indptr)), indices] = torch.as_tensor(
        values)
    conf["ranks"] = {str(PW): ref.dense_rank(D, 42013)}
    path.write_text(json.dumps(conf))
    return tiny_root


@pytest.mark.parametrize("trace", [0, 1])
def test_wide_cell_is_correct(wide_root, capsys, trace):
    rc, res, err = run(wide_root, capsys,
                       *cell_args("mk12.wide", 2 ** 33 + 5, trace))
    assert rc == 0 and res["correct"] is True
    assert res["checks"] == {k: {"value": 0, "limit": 0} for k in
                             ("rank_gap", "echelon_faults", "span_residual")}
    if trace:
        assert WIDE_METRICS <= set(res["metrics"])
        assert res["metrics"]["step_sweep.launches"]["unit"] == "launches"
        assert res["metrics"]["rank_finisher.rows_blocks"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"call_s", "setup_s"}


def test_rows_cell_reports_rows_blocks(wide_root, capsys):
    rc, res, _ = run(wide_root, capsys, *cell_args("mk12.rank", 13, 1))
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["rank_finisher.rows_blocks"]["value"] >= 1
    # no d >= 3 sweep and no metric of the wide cell at 42013
    assert not WIDE_METRICS - {"rank_finisher.rows_blocks"} \
        & set(res["metrics"])


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_wide_fault_is_not_correct(wide_root, capsys, fault, monkeypatch):
    from spasm_tpu_torch.dense import modp
    monkeypatch.setattr(modp, "_mm8", modp._mm8)     # bf16 patches it
    rc, res, _ = run(wide_root, capsys,
                     *cell_args("mk12.wide", 17, 0, "--fault", fault))
    assert rc == 0 and res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
