"""On the card: the one command runs a cell correct, and the
lower-precision control at the cell's own size comes out not correct.
Skips without an NVIDIA card (decided inside each test)."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def run(*argv):
    r = subprocess.run([sys.executable, "benchmark/run.py", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    return r.returncode, json.loads(lines[-1]) if lines else None


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cell_on_card():
    need_card()
    rc, res = run("--workload", "mk13b5.rank", "--seed", "2147483659",
                  "--seconds", "5", "--trace", "0")
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_on_card():
    need_card()
    rc, res = run("--workload", "mk13b5.rank", "--seed", "2147483659",
                  "--seconds", "5", "--trace", "0", "--fault", "bf16")
    assert rc == 0 and res["correct"] is False
