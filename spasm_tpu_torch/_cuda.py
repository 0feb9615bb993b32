"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled by nvcc for sm_90a, one process per source, all
at once, and linked into one shared library with a plain C interface (no
PyTorch headers: seconds to build), under `build/spasm_tpu_torch/` at
the repository root, on first use.  They are
rebuilt when a source is newer than the library.  The library is loaded
with ctypes; every pointer and the stream pass as c_void_p, and every C
entry returns cudaGetLastError(), which `check` turns into an exception.

`launches` counts the CUDA kernel launches each wrapper issued: B1 the
substitution sweep (dense/subst.py, one per call; "B1 wide" its
int32-storage kernel, p > 65535), B2 and B3 the row
sweeps (dense/rowrref.py; B2 counted again by variant, "B2 cluster" one
launch per sweep, "B2 pair" two per Jordan step), B4 the panel steps of
the column-sweep elimination (dense/panel.py), counted apart in RREF and
LU mode and, again, by variant (cluster or cooperative), B12 the
gather-combine that forms the rank finisher's blocks at d >= 3
(dense/reduced.py, one per chunk of rows).  `calls` counts
the wrapper calls that launched B1 or B1 wide (reduced-basis builds) and
B2 (sweeps), so a run can show launches per call.  Nothing here runs at
import.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Optional

_HERE = pathlib.Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_SOURCES = ("subst.cu", "row_sweep.cu", "panel.cu", "combine.cu")
_HEADERS = ("modp.cuh", "cluster.cuh", "device.cuh")
BUILD_DIR = _HERE.parent / "build" / "spasm_tpu_torch"

launches: Dict[str, int] = {"B1": 0, "B1 wide": 0, "B2": 0,
                             "B2 cluster": 0,
                             "B2 pair": 0, "B3": 0, "B4 rref": 0,
                             "B4 lu": 0, "B4 cluster": 0,
                             "B4 cooperative": 0, "B12": 0}
calls: Dict[str, int] = {"B1": 0, "B1 wide": 0, "B2": 0}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # set when this process compiled
build_log = ""


def reset_launches() -> None:
    for d in (launches, calls):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(pathlib.Path(home) / "bin" / "nvcc")


def _build(so: pathlib.Path) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC"]
    t0 = time.time()
    objs, procs = [], []
    for s in _SOURCES:
        obj = str(BUILD_DIR / f"{s}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc()] + flags + ["-Xptxas", "-v", "-c", str(_CSRC / s),
                                 "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    for pr in procs:
        out, _ = pr.communicate(timeout=600)
        logs.append(out)
        failed |= pr.returncode != 0
    build_log = "".join(logs)
    if not failed:
        tmp = f"{so}.{tag}"
        r = subprocess.run([_nvcc()] + flags + ["-shared", "-o", tmp] + objs,
                           capture_output=True, text=True, timeout=600)
        build_log += r.stdout + r.stderr
        failed = r.returncode != 0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + build_log[-4000:])
    os.replace(tmp, so)
    build_seconds = time.time() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if missing or stale)."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / "libspasm_cuda.so"
    deps = [_CSRC / s for s in _SOURCES + _HEADERS]
    if not so.exists() or so.stat().st_mtime < max(
            d.stat().st_mtime for d in deps):
        _build(so)
    L = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    L.spasm_subst_waves.restype = ci
    L.spasm_subst_waves.argtypes = [vp, ci, vp, ci, ci, ci, ci, ci, vp]
    L.spasm_subst_waves_wide.restype = ci
    L.spasm_subst_waves_wide.argtypes = [vp, ci, vp, ci, ci, ci, ci,
                                         ctypes.c_longlong, ci, vp]
    L.spasm_subst_blocks_per_sm.restype = ci
    L.spasm_subst_blocks_per_sm.argtypes = [ci]
    L.spasm_subst_cols.restype = ci
    L.spasm_subst_cols.argtypes = []
    L.spasm_row_sweep.restype = ci
    L.spasm_row_sweep.argtypes = [vp, ci, ci, vp, vp, ci, vp]
    L.spasm_row_sweep_cluster.restype = ci
    L.spasm_row_sweep_cluster.argtypes = [vp, ci, ci, vp, ci, vp]
    L.spasm_row_sweep_cluster_cols.restype = ci
    L.spasm_row_sweep_cluster_cols.argtypes = []
    L.spasm_row_sweep_tiles.restype = ci
    L.spasm_row_sweep_tiles.argtypes = [vp, ci, vp, vp, ci, vp]
    L.spasm_tile_state_size.restype = ci
    L.spasm_tile_state_size.argtypes = []
    L.spasm_panel.restype = ci
    L.spasm_panel.argtypes = [vp, ctypes.c_longlong, ci, vp, vp, vp, vp, vp,
                              vp, vp, vp, ci, ci, ci, vp]
    L.spasm_panel_stamped.restype = ci
    L.spasm_panel_stamped.argtypes = L.spasm_panel.argtypes[:-1] + [vp, vp]
    L.spasm_panel_cluster_rows.restype = ci
    L.spasm_panel_cluster_rows.argtypes = []
    L.spasm_tile_width.restype = ci
    L.spasm_tile_width.argtypes = []
    ll = ctypes.c_longlong
    L.spasm_gather_combine.restype = ci
    L.spasm_gather_combine.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ll,
                                       ci, ll, ci, vp]
    _lib = L
    return L


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t) -> int:
    """Handle of the current CUDA stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
