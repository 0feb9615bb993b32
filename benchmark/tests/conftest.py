"""The benchmark's own tests (python -m pytest benchmark/tests from the
repository root).  Tests marked `cuda` need an NVIDIA card and skip
without one; the rest run on the CPU, the program's plain versions at
tiny sizes."""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


# tiny stand-ins of the cells: the same mixes and readers, small matrices
TINY_CONFIGS = {
    "mk9.b3": {"generator": "matching_complex",
               "args": {"n": 9, "j": 3, "transpose": True}},
    "tref600": {"generator": "trefethen", "args": {"n": 600}},
}
TINY_CELLS = {                 # tiny cell -> (config, traffic, the cell)
    "mk.rank": ("mk9.b3", "rank.tiny", "mk13b5.rank"),
    "tref.pluq": ("tref600", "pluq.p42013", "trefethen20k.pluq"),
}


def make_tiny_root(dest: pathlib.Path) -> pathlib.Path:
    """A checkout-like directory: BENCHMARK.json with the tiny cells and
    a copy of benchmark/ (configs, mixes, metrics, matrices)."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, conf in TINY_CONFIGS.items():
        (dest / "benchmark" / "configs" / f"{name}.json").write_text(
            json.dumps(dict(conf, name=name, ranks={})))
    rank = json.loads((BENCH / "mixes" / "rank.p42013.json").read_text())
    # the rank finisher takes small inputs only below its work floor
    rank["options"] = {"device_dense_min": 0}
    (dest / "benchmark" / "mixes" / "rank.tiny.json").write_text(
        json.dumps(dict(rank, name="rank.tiny")))
    spec["configs"] = [{"name": n, "source": "tiny", "reduced": [],
                        "file": f"benchmark/configs/{n}.json", "why": "test"}
                       for n in TINY_CONFIGS]
    spec["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1,
                          "why": "test"} for w, (c, t, _) in TINY_CELLS.items()]
    real = {cell: w for w, (_, _, cell) in TINY_CELLS.items()}
    for m in spec["per_layer"] + spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
