"""Mesh context: opt-in multi-device execution for the whole engine.

    with use_mesh(make_mesh()):
        fact = echelonize(A)

Port of spasm_tpu/parallel/context.py, for a single controller: one
Python process places every shard and issues every collective itself.
Where the JAX package annotated arrays with NamedShardings and let XLA's
SPMD partitioner insert the collectives, each sharded stage here does its
per-shard work explicitly, and the collectives below are the only places
where data moves between devices:

  * `shard_rows` (P('rows', None)): row block i on mesh.devices[i, 0];
  * `shard_cols` (P(None, 'cols')): column block j on mesh.devices[0, j];
  * `replicated`: a copy on every device a row shard lives on;
  * `broadcast` (to shards), `all_gather_cols`, `gather` (to one device)
    and `sum_count` (the sum of a rank count).

A sharded value is a plain container (`Sharded`): its shards in mesh
order, the axis, the mesh, and `gather`.  The single controller computes
each shard once; the replicas that P('rows', None) keeps along 'cols'
(and P(None, 'cols') along 'rows') are left out, since they would repeat
the same work.  Every placement copies, also onto the device the data
already lies on: a device may repeat in a mesh (`cuda:0` four times, the
CPU eight times in the tests), the engine updates shards in place, and a
shard that shared storage with another would corrupt it.

The collectives are `tensor.to(device, copy=True)` copies (peer copies
over NVLink between distinct cards of one host).  Each adds the bytes it
copies to `moved_bytes[site]` and one to `site_calls[site]`, where site
is the JAX package's site that placed the data (`SITES`); site 7, the
width cap, moves nothing and is counted by `count`.  Without a mesh
every function returns its input unchanged and the single-device path is
the one it always was.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .dist import Mesh

# The JAX package's mesh sites, by the number chip_smoke.py and PERF.md
# use; what the port counts under each.
SITES = {
    1: "dense/block.py:461 UEliminator.pad_block (rows)",
    2: "dense/block.py:486 _dispatch_runs (chunk bases replicated)",
    3: "dense/elim.py:395-461 _eliminate (cols: panel broadcasts, "
       "pivot-row gathers)",
    4: "dense/reduced.py:260 ReducedBasis build (cols; the completion "
       "test's residue)",
    5: "dense/reduced.py:550 form_block (cols; CompactBasis and the row "
       "sweep on the formed blocks)",
    6: "schur.py:69 _block_rows_device, device_csr.py:150 densify (rows)",
    7: "echelonize.py:1334, :1422 width cap x col_quantum",
}

moved_bytes: Dict[int, int] = {s: 0 for s in SITES}
site_calls: Dict[int, int] = {s: 0 for s in SITES}

_ACTIVE: List[Mesh] = []


def reset_counts() -> None:
    for d in (moved_bytes, site_calls):
        for k in d:
            d[k] = 0


def count(site: Optional[int], nbytes: int = 0) -> None:
    """One call at `site`, which moved nbytes."""
    if site is not None:
        site_calls[site] += 1
        moved_bytes[site] += int(nbytes)


def current_mesh() -> Optional[Mesh]:
    """The innermost active mesh, or None (single-device execution)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Run the engine's device stages sharded over `mesh`."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def mesh_device(mesh: Optional[Mesh] = None) -> Optional[torch.device]:
    """The mesh's first device: where the engine's unsharded device state
    lives and where a gather lands."""
    mesh = mesh or current_mesh()
    return None if mesh is None else mesh.devices[0, 0]


def row_quantum(mesh: Optional[Mesh] = None) -> int:
    """Row-padding quantum so every row shard holds an equal slice."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else mesh.shape["rows"]


def col_quantum(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    return 1 if mesh is None else mesh.shape["cols"]


def shard_devices(mesh: Mesh, axis: int) -> List[torch.device]:
    """The device of each shard along axis 0 ('rows') or 1 ('cols')."""
    return list(mesh.devices[:, 0] if axis == 0 else mesh.devices[0, :])


class Sharded:
    """A tensor split over a mesh: shards in mesh order along `axis` (0:
    row blocks, shard i on mesh.devices[i, 0]; 1: column blocks, shard j
    on mesh.devices[0, j]; None: replicas, one per row shard)."""

    __slots__ = ("shards", "axis", "mesh")

    def __init__(self, shards: Sequence[torch.Tensor], axis: Optional[int],
                 mesh: Mesh):
        self.shards = list(shards)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        if self.axis is not None:
            s[self.axis] = sum(t.shape[self.axis] for t in self.shards)
        return tuple(s)

    @property
    def device(self) -> torch.device:
        """The first shard's device (the mesh's first device)."""
        return self.shards[0].device

    def map(self, fn) -> "Sharded":
        """fn applied to every shard, on its own device."""
        return Sharded([fn(t) for t in self.shards], self.axis, self.mesh)

    def bounds(self) -> List[int]:
        """Offsets of the shards along the axis (len(shards) + 1)."""
        return [0] + list(np.cumsum([t.shape[self.axis]
                                     for t in self.shards]))

    def gather(self, device=None, site: Optional[int] = None
               ) -> torch.Tensor:
        return gather(self, device, site)


def smap(fn, x):
    """fn(x), or fn on every shard of a Sharded x."""
    return x.map(fn) if isinstance(x, Sharded) else fn(x)


def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    # never non_blocking into host memory: the caller may read it at once
    return t.to(device, copy=True, non_blocking=device.type == "cuda",
                memory_format=torch.contiguous_format)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _split(X, mesh: Mesh, axis: int, site: Optional[int]) -> Sharded:
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.ascontiguousarray(X))
    devs = shard_devices(mesh, axis)
    k = len(devs)
    if X.shape[axis] % k:
        raise ValueError(f"axis {axis} of {tuple(X.shape)} does not split "
                         f"into {k} shards")
    parts = torch.chunk(X, k, dim=axis)
    out = [_copy(t, d) for t, d in zip(parts, devs)]
    count(site, sum(_nbytes(t) for t in out))
    return Sharded(out, axis, mesh)


def shard_rows(X, mesh: Optional[Mesh] = None, site: Optional[int] = None):
    """Place X (B, ...) in row blocks (B a multiple of row_quantum);
    X unchanged without a mesh."""
    mesh = mesh or current_mesh()
    return X if mesh is None else _split(X, mesh, 0, site)


def shard_cols(X, mesh: Optional[Mesh] = None, site: Optional[int] = None):
    """Place X (n, m) in column blocks (m a multiple of col_quantum);
    X unchanged without a mesh."""
    mesh = mesh or current_mesh()
    return X if mesh is None else _split(X, mesh, 1, site)


def replicated(X, mesh: Optional[Mesh] = None, site: Optional[int] = None):
    """A copy of X on the device of every row shard (the consumers of a
    replicated operand here are the row-sharded stages); X unchanged
    without a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return X
    return Sharded(broadcast(X, shard_devices(mesh, 0), site), None, mesh)


def broadcast(x: torch.Tensor, devices: Sequence[torch.device],
              site: Optional[int] = None) -> List[torch.Tensor]:
    """A copy of x on each of `devices` (one call at `site`)."""
    out = [_copy(x, torch.device(d)) for d in devices]
    count(site, _nbytes(x) * len(out))
    return out


def gather(x, device=None, site: Optional[int] = None) -> torch.Tensor:
    """The whole of a Sharded, its shards concatenated along the axis, on
    `device` (default: the first shard's); a plain tensor is returned as
    it is (moved to `device` when one is given).  The bytes counted are
    those of the shards that leave their mesh slot: all of them for a
    device outside the mesh's first slot."""
    if not isinstance(x, Sharded):
        return x if device is None else x.to(device)
    if x.axis is None:
        raise ValueError("gather takes a row- or column-sharded value")
    first = device is None
    device = x.device if device is None else torch.device(device)
    parts = x.shards
    moved = parts[1:] if first else parts
    out = torch.cat([t if t.device == device else _copy(t, device)
                     for t in parts], dim=x.axis)
    count(site, sum(_nbytes(t) for t in moved))
    return out


def all_gather_cols(pieces: Sequence[torch.Tensor], mesh: Mesh,
                    site: Optional[int] = None) -> List[torch.Tensor]:
    """pieces[j] (B, k_j) on column shard j's device -> on every column
    shard's device, the (B, sum k_j) concatenation of all pieces in shard
    order."""
    devs = shard_devices(mesh, 1)
    out, nbytes = [], 0
    for i, d in enumerate(devs):
        got = []
        for j, t in enumerate(pieces):
            if i == j:
                got.append(t)
            else:
                got.append(_copy(t, d))
                nbytes += _nbytes(t)
        out.append(torch.cat(got, dim=1))
    count(site, nbytes)
    return out


def sum_count(values: Sequence[torch.Tensor],
              site: Optional[int] = None) -> int:
    """The sum over shards of a per-shard count (0-d tensors), on the
    host."""
    count(site, 8 * len(values))
    return int(sum(int(v) for v in values))
