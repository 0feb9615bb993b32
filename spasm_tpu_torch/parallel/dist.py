"""Mesh construction for multi-device execution.

Port of spasm_tpu/parallel/dist.py.  The engine is mesh-aware: running
`echelonize` inside `use_mesh(make_mesh())` (parallel/context.py) shards
every device stage: row-sharded block elimination and densified Schur
blocks (DP, the analog of the reference's `omp parallel for` over Schur
rows, spasm_schur.c:86), the column-sharded dense elimination (TP) and
the reduced basis's width (SP).  One Python process drives every device
of the mesh (a single controller, as the JAX package's one process drives
every device of `jax.devices()`): it places the shards and issues every
collective itself (context.py).  A device may repeat in a mesh, so every
sharded stage also runs on one card.

`Mesh` is the port's own small class: it needs no process group, unlike
`torch.distributed.DeviceMesh`.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

AXES = ("rows", "cols")


class Mesh:
    """A ('rows', 'cols') grid of torch devices.  devices: (rows, cols)
    numpy object array of `torch.device`; shape {"rows": r, "cols": c};
    size r * c.  A device may appear more than once."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (rows, cols) grid")
        self.devices = devices
        self.axis_names = AXES
        self.shape = {"rows": int(devices.shape[0]),
                      "cols": int(devices.shape[1])}
        self.size = int(devices.size)

    def __repr__(self) -> str:
        return (f"Mesh(rows={self.shape['rows']}, cols={self.shape['cols']}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")


def _grid(devices: Sequence[torch.device], rows: int, cols: int) -> Mesh:
    grid = np.empty(len(devices), object)
    grid[:] = list(devices)
    return Mesh(grid.reshape(rows, cols))


def make_mesh(n_devices: Optional[int] = None, devices=None,
              process_of: Optional[Callable] = None) -> Mesh:
    """A ('rows', 'cols') mesh over `devices` (default: every CUDA device
    of `torch.cuda.device_count()`, the first `n_devices` of them when
    given; without CUDA `devices` must be given).

    Two-level when `process_of` (device -> process id; injectable for
    tests, every device in one process by default) splits the devices
    evenly over several processes: 'rows' runs across the processes and
    'cols' within one.  Otherwise the rows-heavy single-level
    factorization of spasm_tpu/parallel/dist.py: 8 -> (4, 2), 4 -> (2,
    2), 2 -> (2, 1)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices= (e.g. [torch.device('cpu')] * 8)")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i)
                   for i in range(min(n_devices or count, count))]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if process_of is None:
        process_of = lambda d: 0  # noqa: E731
    procs = {}
    for i, d in enumerate(devices):
        procs.setdefault(process_of(d), []).append(i)
    nproc = len(procs)
    per = len(devices) // nproc
    if nproc > 1 and all(len(v) == per for v in procs.values()):
        order = [i for k in sorted(procs) for i in procs[k]]
        return _grid([devices[i] for i in order], nproc, per)
    rows, cols = len(devices), 1
    while rows % 2 == 0 and cols < rows // 2:
        rows //= 2
        cols *= 2
    return _grid(devices, rows, cols)


def shard_rows(mesh: Mesh, X):
    """X (B, ...) placed in row blocks over the mesh's 'rows' axis."""
    from .context import shard_rows as place
    return place(X, mesh)


def shard_cols(mesh: Mesh, X):
    """X (n, m) placed in column blocks over the mesh's 'cols' axis."""
    from .context import shard_cols as place
    return place(X, mesh)


def replicate(mesh: Mesh, X):
    """A copy of X on every device a row shard of the mesh lives on."""
    from .context import replicated
    return replicated(X, mesh)
