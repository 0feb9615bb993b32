"""Dense GF(p) device arithmetic of the port, with the exports of
`spasm_tpu.dense`:

  * modp.modp_matmul (and modp.modp_matmul_np, numpy in and out) — exact
    mod-p matmul by int8 digit products (`matmul_digits`, torch._int_mm);
    modp.dnorm, modp.device_field — the balanced residue, the digit tier;
  * elim.dense_rref / elim.dense_lu — blocked RREF / PLUQ with column
    pivoting (`_eliminate`: kernel B4 at d = 2).

Each takes a trailing `device=` ("cuda" unless the caller passes "cpu").
The rest: reduced (the reduced basis, kernel B1 in subst), rowrref (the
row-sweep RREF, kernels B2 and B3), panel (kernel B4), block
(UEliminator).
"""

from .modp import modp_matmul, dnorm, device_field  # noqa: F401
from .elim import dense_rref, dense_lu              # noqa: F401
