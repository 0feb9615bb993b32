#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json on one NVIDIA card and prints one
JSON line (the last of standard output):

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--fault stale|alter|drop|half|bf16]

from the root of a checkout.  --trace 0 prints the cell's end-to-end
metrics (call_s, setup_s), --trace 1 its per-layer metrics from whole
calls under torch.profiler.  --fault plants a fault, or with bf16 the
lower-precision control, under the timed path: the run must then report
`correct` false (benchmark/tests).  Without a card it exits 1 and
prints no result; it exits 3 if jax, jaxlib, flax or spasm_tpu was
loaded.  The kernels' build and the CUDA JIT cache stay under build/ in
the checkout.
"""
import os
import pathlib
import sys
import time

T_START = time.time()
ROOT = pathlib.Path(__file__).resolve().parent.parent
# the kernels are built by nvcc into build/spasm_tpu_torch in the
# checkout; the CUDA JIT cache of any PTX compiled at load stays beside them
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "bench_cache" / "cuda")
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
