"""Kernel B4: the latency-bound part of one panel step of the blocked
column-sweep elimination (dense/elim.py), with its plain version.

Port of spasm_tpu/dense/sweep_pallas.py.  `panel_pivots(P0, is_piv, p,
nb, rref)` takes an (n, nb = 64) int32 column panel P0 (a view of the
block being eliminated: unit column stride, any row stride) and the
(n,) bool mask of rows already pivotal, and returns

    (lrows, lhas, is_piv', Z)           RREF: Z = W^-1
    (lrows, lhas, is_piv', Z, Vinv)     LU: Z = D^-1 Lambda^-1, Vinv the
                                        inverse of the unit-upper D^-1 Omega

with lrows (nb,) int32 pivot row per slot (-1 if none), lhas (nb,) bool,
is_piv' (n,) bool and W the panel's pivot minor (identity on empty
slots).  A CUDA tensor launches the kernel (csrc/panel.cu, one launch:
the cluster variant up to CLUSTER_ROWS rows, the cooperative one above,
chosen by n alone; a launch that fails raises); a CPU tensor takes
`_panel_plain`, the XLA path of the JAX package (`elim.panel_steps`:
`_discovery_sweep`, W assembly, `_jordan_inverse` / `_forward_factor` +
`_unit_upper_inverse_small`), which the JAX tests hold against the
Pallas kernel.  Every output is unique (first-available-row pivots; the
inverse and LU factors of W), so the two agree bit for bit.  The d == 2
tier only (p <= 65279: the division-free updates need 2 (p/2)^2 <
2^31); a larger prime raises before any launch, and `elim._eliminate`
never hands one here.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .elim import panel_steps as _panel_plain
from .modp import check_small

NB = 64          # the kernel's panel width (csrc/panel.cu kNB)
CLUSTER_ROWS = 16 * 1536    # the cluster variant's most rows (kCluster *
                            # kRowsMax)


def _check(P0: torch.Tensor, is_piv: torch.Tensor, p: int, nb: int):
    check_small(p, "kernel B4")
    if nb != NB:
        raise ValueError(f"the panel kernel takes nb = {NB}, got {nb}")
    if (P0.dtype != torch.int32 or P0.dim() != 2 or P0.shape[1] != nb
            or P0.stride(1) != 1 or P0.shape[0] == 0):
        raise ValueError("P0 must be an (n >= 1, 64) int32 panel with unit "
                         "column stride")
    if (is_piv.dtype != torch.bool or is_piv.shape != (P0.shape[0],)
            or is_piv.device != P0.device):
        raise ValueError("is_piv must be an (n,) bool tensor on P0's device")


def panel_variant(n: int) -> str:
    """The kernel variant an n-row panel takes, by n alone: "cluster" up
    to CLUSTER_ROWS rows (the panel in one cluster's shared memory),
    "cooperative" above (the panel in L2, grid barriers)."""
    return "cluster" if n <= CLUSTER_ROWS else "cooperative"


def panel_pivots(P0: torch.Tensor, is_piv: torch.Tensor, p: int, nb: int,
                 rref: bool):
    """Kernel B4 (see the module docstring)."""
    _check(P0, is_piv, p, nb)
    if P0.device.type == "cpu":
        return _panel_plain(P0, is_piv, p, nb, rref)
    variant = panel_variant(P0.shape[0])
    out = _launch(P0, is_piv, p, rref, None, variant)
    _cuda.launches["B4 rref" if rref else "B4 lu"] += 1
    _cuda.launches[f"B4 {variant}"] += 1
    return out


def panel_phase_stamps(P0: torch.Tensor, is_piv: torch.Tensor, p: int,
                       rref: bool, variant: str):
    """B4 on a CUDA panel, built with its phase stamps: a measurement for
    chip_smoke.py, outside the launch counts, which may also ask for the
    cooperative variant below its threshold.  Returns (outputs as
    panel_pivots, stamps): stamps (12,) int64 on the card, clock64() of
    the lead block at the start, after the preamble copy, after
    discovery, after the minor's steps, after the inverse and Z, after
    Vinv; then %globaltimer (ns) at the same six points."""
    _check(P0, is_piv, p, NB)
    stamps = torch.zeros(12, dtype=torch.int64, device=P0.device)
    return _launch(P0, is_piv, p, rref, stamps, variant), stamps


def _launch(P0, is_piv, p: int, rref: bool, stamps, variant: str):
    if P0.device.type != "cuda":
        raise ValueError(f"unsupported device {P0.device}")
    n = P0.shape[0]
    nb = NB
    dev = P0.device
    if variant == "cluster" and n > CLUSTER_ROWS:
        raise ValueError(f"the cluster variant takes <= {CLUSTER_ROWS} rows")
    L = _cuda.lib()
    if L.spasm_panel_cluster_rows() != CLUSTER_ROWS:
        raise RuntimeError("csrc/panel.cu disagrees with CLUSTER_ROWS")
    is_piv = is_piv.contiguous()
    lrows = torch.empty(nb, dtype=torch.int32, device=dev)
    lhas = torch.empty(nb, dtype=torch.bool, device=dev)
    piv_out = torch.empty(n, dtype=torch.bool, device=dev)
    Z = torch.empty((nb, nb), dtype=torch.int32, device=dev)
    Vinv = torch.empty((nb, nb), dtype=torch.int32, device=dev)
    Pt = rslot = None
    if variant == "cooperative":
        Pt = torch.empty(nb * n, dtype=torch.int32, device=dev)
        rslot = torch.empty(nb, dtype=torch.int32, device=dev)
    args = (P0.data_ptr(), P0.stride(0), n, is_piv.data_ptr(),
            lrows.data_ptr(), lhas.data_ptr(), piv_out.data_ptr(),
            Z.data_ptr(), Vinv.data_ptr(),
            None if Pt is None else Pt.data_ptr(),
            None if rslot is None else rslot.data_ptr(), p, int(rref),
            int(variant == "cooperative"))
    # cudaLaunchKernelEx / cudaLaunchCooperativeKernel launch on the
    # current device: make it P0's
    with torch.cuda.device(dev):
        if stamps is None:
            err = L.spasm_panel(*args, _cuda.stream_ptr(P0))
        else:
            err = L.spasm_panel_stamped(*args, stamps.data_ptr(),
                                        _cuda.stream_ptr(P0))
    _cuda.check(err, f"kernel B4 (spasm_panel, {variant} variant)")
    if rref:
        return lrows, lhas, piv_out, Z
    return lrows, lhas, piv_out, Z, Vinv
