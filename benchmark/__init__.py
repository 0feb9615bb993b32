"""The benchmark of spasm_tpu_torch: run.py, BENCHMARK.json at the root."""
