"""spasm_tpu_torch — exact sparse linear algebra over GF(p) in PyTorch,
with CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `spasm_tpu` (kept beside it as the
reference).  Ported so far, for every odd prime p <= 2^32 - 5 (three
digit tiers, dense/modp.py; the tools' default modulus is 42013):
`echelonize(A)` through the reference's round loop (host structural
pivot search, sparse Schur complements) and every finisher — the device-resident rank finisher,
the blocked dense finisher (RREF, or LU for complete PLUQ:
`EchelonizeOptions(L=True, complete=True)`), the low-rank finisher with
its completion test and the GPLU finisher on the host — and the
factorization's consumers on the host: `rref`, `kernel` /
`kernel_from_rref`, `solve` / `gesv`, rank certificates (create, verify,
save, load) and `factorization_verify`, `maximum_matching` /
`structural_rank`, `dulmage_mendelsohn` / `strongly_connected_components`;
and the ten CLI tools (`python -m spasm_tpu_torch.cli.rank`, see cli/);
checkpoint/resume of the engine (`EchelonizeOptions(checkpoint_file=F)`,
`--checkpoint F`), its files interchangeable with the JAX package's;
and the mesh (`parallel/`: `with use_mesh(make_mesh()): echelonize(A)`
shards the engine's device stages over the cards one process drives,
bit-identical to one device).

Layout: the host modules (field, csr, hashing, sio, gen, pivots, spmv,
triangular, rref, kernel, solve, certificate, matching, dm and the native
C++ pivot search, triangular solves, GPLU and matching) are vendored from
`spasm_tpu` with only their imports and native entry points changed; the device
side is plain functions on tensors and small classes holding device
tensors (`ReducedBasis`, `CompactBasis`, `UEliminator`).  The
device is explicit: `echelonize(A, opts, device="cuda")`; the CPU runs
only when a caller passes it, taking each kernel's plain torch version.
Nothing here has parameters or gradients, so no `nn.Module` or
`autograd.Function` appears.  The four CUDA kernels (csrc/) are built
by nvcc on first use.

Numbers are balanced integers x in [-(p-1)/2, (p-1)/2], exactly as in
`spasm_tpu` and the reference, so files, fingerprints and PRNG streams
interoperate bit for bit.  Importing this package never imports JAX.
"""

__version__ = "0.1.0"

from .field import Field                                      # noqa: E402
from .csr import CSR, COO                                     # noqa: E402
from .hashing import PRNG, sha256_new                         # noqa: E402
from . import sio                                             # noqa: E402
from .echelonize import EchelonizeOptions, echelonize, LU     # noqa: E402
from .solve import solve, gesv                                # noqa: E402
from .kernel import kernel, kernel_from_rref                  # noqa: E402
from .rref import rref                                        # noqa: E402
from .certificate import (rank_certificate_create,            # noqa: E402
                          rank_certificate_verify,
                          factorization_verify,
                          certificate_save, certificate_load)
from .dm import dulmage_mendelsohn, strongly_connected_components  # noqa: E402
from .matching import maximum_matching, structural_rank       # noqa: E402

__all__ = [
    "Field", "CSR", "COO", "PRNG", "sha256_new", "sio",
    "EchelonizeOptions", "echelonize", "LU", "solve", "gesv",
    "kernel", "kernel_from_rref", "rref",
    "rank_certificate_create", "rank_certificate_verify",
    "factorization_verify", "certificate_save", "certificate_load",
    "dulmage_mendelsohn", "strongly_connected_components",
    "maximum_matching", "structural_rank",
]
