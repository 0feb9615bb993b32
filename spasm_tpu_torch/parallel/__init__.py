"""Multi-device execution: ('rows', 'cols') meshes of torch devices and
the row / column partitions of the engine's device stages.

Port of spasm_tpu/parallel/.  The reference's only parallelism is
single-node OpenMP; here the same row-parallel regions become sharded
device stages, driven by one process (a single controller):

  * data-parallel axis "rows": independent row blocks eliminated against
    a replicated chunk basis (the analog of `omp for` over rows in
    spasm_schur.c:95-96);
  * tensor-parallel axis "cols": the trailing updates of the dense
    elimination are sharded over columns, each panel's pivot data
    broadcast from the shard that owns it; the reduced basis and the
    finisher's blocks shard their width (SP);
  * reductions (rank counts, completion tests) are summed on the host.
"""

from .dist import make_mesh, shard_rows, replicate              # noqa: F401
from .context import use_mesh, current_mesh                     # noqa: F401
