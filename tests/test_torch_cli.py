"""The port's ten CLI tools (spasm_tpu_torch/cli/), twins of every case of
tests/test_cli.py.  The tools that echelonize (rank, echelonize, kernel,
solve) run on the card and have no --device flag, so they run here
in-process through `main(argv)` with `echelonize` patched to the CPU,
and their standard output is held byte for byte to the JAX tool's on the
same input.  The host tools (dm, stack, transpose, vertical_swap,
bitmap, check_cert) run as `python -m spasm_tpu_torch.cli.X` processes,
their output held to the JAX tool's `main(argv)`.  Every tool imports no
JAX, and none finishes on the CPU when CUDA is missing."""
import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spasm_tpu.cli import bitmap as jbitmap
from spasm_tpu.cli import dm as jdm
from spasm_tpu.cli import echelonize as jechelonize_cli
from spasm_tpu.cli import kernel as jkernel_cli
from spasm_tpu.cli import rank as jrank_cli
from spasm_tpu.cli import solve as jsolve_cli
from spasm_tpu.cli import stack as jstack
from spasm_tpu.cli import transpose as jtranspose
from spasm_tpu.cli import vertical_swap as jvertical_swap

from spasm_tpu_torch import echelonize, sio
from spasm_tpu_torch.cli import echelonize as echelonize_cli
from spasm_tpu_torch.cli import kernel as kernel_cli
from spasm_tpu_torch.cli import rank as rank_cli
from spasm_tpu_torch.cli import solve as solve_cli
from tests.torch_parity import MATRIX

torch.set_num_threads(2)

ROOT = MATRIX.parent.parent
TOOLS = ["rank", "check_cert", "echelonize", "kernel", "solve", "dm",
         "stack", "transpose", "vertical_swap", "bitmap"]
ENV = dict(os.environ, PYTHONPATH=str(ROOT))


@pytest.fixture
def on_cpu(monkeypatch):
    """The echelonizing tools' finishers on the CPU; the JAX tools without
    their device warm-up thread."""
    monkeypatch.setenv("SPASM_TPU_NO_WARMUP", "1")
    for mod in (rank_cli, echelonize_cli, kernel_cli, solve_cli):
        monkeypatch.setattr(mod, "echelonize",
                            functools.partial(echelonize, device="cpu"))


def _both(capsys, port, jax, argv):
    """Runs the port's and the JAX tool's main(argv); both exit 0 and
    print the same standard output.  Returns the port's (out, err)."""
    assert port.main(argv) == 0
    got = capsys.readouterr()
    assert jax.main(argv) == 0
    assert capsys.readouterr().out == got.out
    return got


def run_tool(tool, args, stdin_file=None, stdin_data=None, env=ENV):
    cmd = [sys.executable, "-m", f"spasm_tpu_torch.cli.{tool}"] + args
    if stdin_file is not None:
        stdin_data = open(stdin_file, "rb").read()
    return subprocess.run(cmd, input=stdin_data, capture_output=True,
                          env=env, timeout=600, cwd=ROOT)


def _jax_out(capsys, tool, argv) -> bytes:
    assert tool.main(argv) == 0
    return capsys.readouterr().out.encode()


def test_rank_tool(on_cpu, capsys):
    out = _both(capsys, rank_cli, jrank_cli,
                ["--modulus", "257", "--matrix", str(MATRIX / "singular.sms")])
    assert out.out.strip() == "15"


def test_rank_tool_transposes_wide(on_cpu, capsys):
    out = _both(capsys, rank_cli, jrank_cli,
                ["--matrix", str(MATRIX / "rectangular_l.sms")])
    assert "transposing" in out.err


def test_rank_certificate_flow(on_cpu, capsys, tmp_path):
    """rank -c -o writes the JAX tool's certificate byte for byte; the
    port's check_cert accepts it on the matrix and refuses it on
    another."""
    cert, jcert = tmp_path / "cert.txt", tmp_path / "jcert.txt"
    argv = ["--modulus", "257", "-c", "--matrix",
            str(MATRIX / "singular.sms"), "-o"]
    assert rank_cli.main(argv + [str(cert)]) == 0
    out = capsys.readouterr()
    assert "CORRECT certificate" in out.err and out.out.strip() == "15"
    assert jrank_cli.main(argv + [str(jcert)]) == 0
    assert capsys.readouterr().out == out.out
    assert cert.read_bytes() == jcert.read_bytes()
    r2 = run_tool("check_cert", ["--modulus", "257", "-c", str(cert)],
                  stdin_file=MATRIX / "singular.sms")
    assert r2.returncode == 0, r2.stderr.decode()
    assert b"CORRECT" in r2.stderr
    r3 = run_tool("check_cert", ["--modulus", "257", "-c", str(cert)],
                  stdin_file=MATRIX / "small.sms")
    assert r3.returncode == 1


@pytest.mark.parametrize("extra", [[], ["--rref"],
                                   ["--low-rank-start-weight", "2"]])
def test_echelonize_tool(on_cpu, capsys, extra):
    out = _both(capsys, echelonize_cli, jechelonize_cli,
                ["--modulus", "257", "--matrix", str(MATRIX / "small.sms")]
                + extra)
    U, _ = sio.load_csr(io.BytesIO(out.out.encode()), 257)
    assert U.n <= U.m


@pytest.mark.parametrize("extra", [[], ["--left"]])
def test_kernel_tool(on_cpu, capsys, extra):
    out = _both(capsys, kernel_cli, jkernel_cli,
                ["--modulus", "257", "--matrix",
                 str(MATRIX / "singular.sms")] + extra)
    K, _ = sio.load_csr(io.BytesIO(out.out.encode()), 257)
    assert K.n == 1      # singular.sms has rank 15, 16 columns


def test_kernel_tool_output_file(on_cpu, capsys, tmp_path):
    argv = ["--modulus", "257", "--matrix", str(MATRIX / "G2.sms"), "-o"]
    assert kernel_cli.main(argv + [str(tmp_path / "K")]) == 0
    assert jkernel_cli.main(argv + [str(tmp_path / "JK")]) == 0
    assert (tmp_path / "K").read_bytes() == (tmp_path / "JK").read_bytes()


@pytest.mark.parametrize("name", ["singular.sms", "dm.sms"])
def test_solve_tool(on_cpu, capsys, name):
    _both(capsys, solve_cli, jsolve_cli,
          ["--modulus", "257", "--rhs", str(MATRIX / name), "--matrix",
           str(MATRIX / name)])


def test_solve_tool_output_file(on_cpu, capsys, tmp_path):
    argv = ["--modulus", "257", "--rhs", str(MATRIX / "small.sms"),
            "--matrix", str(MATRIX / "small.sms"), "-o"]
    assert solve_cli.main(argv + [str(tmp_path / "X")]) == 0
    assert jsolve_cli.main(argv + [str(tmp_path / "JX")]) == 0
    assert (tmp_path / "X").read_bytes() == (tmp_path / "JX").read_bytes()


@pytest.mark.parametrize("args", [["-v"], ["-t"], [], ["-P"],
                                  ["-i", "0.0001"]])
def test_dm_tool(capsys, args):
    r = run_tool("dm", args, stdin_file=MATRIX / "dm.sms")
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == _jax_out(capsys, jdm,
                                args + ["--matrix", str(MATRIX / "dm.sms")])
    if args == ["-v"]:
        assert b"structural rank" in r.stdout


def test_stack_tool(capsys, tmp_path):
    # build an input with an empty row/column
    data = b"3 3 M\n1 1 1\n3 3 1\n0 0 0\n"
    r = run_tool("stack", [], stdin_data=data)
    assert r.returncode == 0, r.stderr.decode()
    assert b"2 2 M" in r.stdout
    (tmp_path / "in.sms").write_bytes(data)
    assert r.stdout == _jax_out(capsys, jstack,
                                ["--matrix", str(tmp_path / "in.sms")])


def test_vertical_swap_roundtrip(capsys):
    raw = (MATRIX / "small.sms").read_bytes()
    r1 = run_tool("vertical_swap", [], stdin_data=raw)
    r2 = run_tool("vertical_swap", [], stdin_data=r1.stdout)
    A, _ = sio.load_csr(io.BytesIO(raw), 42013)
    B, _ = sio.load_csr(io.BytesIO(r2.stdout), 42013)
    assert np.array_equal(A.todense(), B.todense())
    assert r1.stdout == _jax_out(capsys, jvertical_swap,
                                 ["--matrix", str(MATRIX / "small.sms")])


def test_transpose_tool(capsys):
    r = run_tool("transpose", [], stdin_file=MATRIX / "small.sms")
    assert r.returncode == 0, r.stderr.decode()
    A, _ = sio.load_csr(MATRIX / "small.sms", 42013)
    T, _ = sio.load_csr(io.BytesIO(r.stdout), 42013)
    assert np.array_equal(A.todense().T, T.todense())
    assert r.stdout == _jax_out(capsys, jtranspose,
                                ["--matrix", str(MATRIX / "small.sms")])


@pytest.mark.parametrize("args,magic", [(["--width", "10", "--height", "10"],
                                         b"P1"),
                                        (["--gray", "-W", "10", "-H", "10"],
                                         b"P2")])
def test_bitmap_tool(capsys, args, magic):
    r = run_tool("bitmap", args, stdin_file=MATRIX / "medium.sms")
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.startswith(magic)
    assert r.stdout == _jax_out(capsys, jbitmap,
                                args + ["--matrix", str(MATRIX / "medium.sms")])


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax(tool):
    """A fresh process importing the tool loads no module of JAX, jaxlib
    or the JAX package."""
    code = (f"import sys, spasm_tpu_torch.cli.{tool}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spasm_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       env=ENV, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stdout.decode() + r.stderr.decode()


@pytest.mark.parametrize("tool,args", [
    ("rank", ["-c"]), ("echelonize", []), ("kernel", []),
    ("solve", ["--rhs", str(MATRIX / "singular.sms")])])
def test_echelonizing_tools_need_cuda(tool, args):
    """With no card visible, the tools that echelonize stop with an error
    instead of finishing on the CPU (a 16 x 16 L-mode input never
    touches the device)."""
    r = run_tool(tool, ["--modulus", "257"] + args,
                 stdin_file=MATRIX / "singular.sms",
                 env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout == b""
    assert b"CUDA is not available" in r.stderr
