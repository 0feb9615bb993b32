"""The benchmark of spasm_tpu_torch on one NVIDIA card (see run.py).

Everything that belongs to one configuration, traffic mix, operation or
per-layer metric is a file of its own, found by the name BENCHMARK.json
(or the mix) gives:

  configs/<file>        the matrix: its generator, arguments and ranks
  matrices/<gen>.py     frozen input generators: generate(**args)
  mixes/<traffic>.json  the operation, the program's options, the prime
  operations/<op>.py    call(prog, torch, A, opts, dev) -> (answers,
                        {clock: seconds}), one timed call that ends with
                        its answers on the host and the device
                        synchronized; check(cell, inputs, kept, dev,
                        torch) -> [{number: count}] for the kept calls
                        (limit 0 each); optional launch(...) (the call's
                        device work alone: the warm-up and the traced
                        run's replay) and plant(answers, fault, p)
  metrics/<metric>.py   read(rec) -> float or None, on the traced record
                        (tracing.py)

A run builds the configuration's matrix, makes every call's input from
the seed (the matrix under fresh +-1 row and column scalings: the same
structure, rank and |values|, so the same route, and answers that differ
from seed to seed), warms up the device work of one call of the cell's
own kind, then makes calls back to back for `--seconds` (a closed loop,
one caller).  After the window it checks a sample of the calls, drawn
from the seed, against the plain reference, and prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import math
import pathlib
import resource
import subprocess
import sys
import time

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spasm_tpu")
FAULTS = ("stale", "alter", "drop", "half", "bf16")
CHECKED_CALLS = 2        # calls of a window the reference checks
TRACED_CALLS = 2         # whole calls under the profiler in a traced run


def load_module(path: pathlib.Path):
    """A reader or generator module from its file (names may hold dots)."""
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads, with its files."""

    def __init__(self, name: str, root: pathlib.Path, data: pathlib.Path):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"benchmark: no workload {name!r} in "
                             "BENCHMARK.json")
        self.name, self.spec, self.data = name, spec, data
        self.cell = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.cell["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.mix = json.loads(
            (data / "mixes" / f"{self.cell['traffic']}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]
        self.prime = int(self.mix["prime"])

    def matrix(self):
        """(n, m, indptr, indices, values) as published, zeros mod p
        dropped, values balanced mod p (int64)."""
        gen = load_module(self.data / "matrices"
                          / f"{self.config['generator']}.py")
        n, m, indptr, indices, values = gen.generate(**self.config["args"])
        p = self.prime
        v = np.remainder(np.asarray(values, np.int64), p)
        v = np.where(v > p // 2, v - p, v)
        keep = v != 0
        if not keep.all():
            rows = np.repeat(np.arange(n), np.diff(indptr))[keep]
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
            indices, v = np.asarray(indices)[keep], v[keep]
        return n, m, np.asarray(indptr, np.int64), \
            np.asarray(indices, np.int32), v

    def operation(self):
        return load_module(self.data / "operations"
                           / f"{self.mix['operation']}.py")

    def readers(self):
        return {m["name"]: load_module(self.data / "metrics"
                                       / f"{m['name']}.py")
                for m in self.per_layer}


class Inputs:
    """Call i's input: the matrix with the signs of rows and columns
    drawn from (seed, i); i = -1 is the warm-up's."""

    def __init__(self, base, p: int, seed: int):
        self.n, self.m, self.indptr, self.indices, self.values = base
        self.p, self.seed = p, seed % (1 << 64)
        self.rows = np.repeat(np.arange(self.n, dtype=np.int64),
                              np.diff(self.indptr))
        self.pool = {}

    def data(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1, i + 1])
        rs = rng.integers(0, 2, self.n, dtype=np.int8) * 2 - 1
        cs = rng.integers(0, 2, self.m, dtype=np.int8) * 2 - 1
        return (self.values * rs[self.rows] * cs[self.indices]).astype(
            np.int32)

    def fill(self, count: int) -> None:
        """Make the inputs of calls 0 .. count - 1 ahead of the window."""
        for i in range(count):
            if i not in self.pool:
                self.pool[i] = self.data(i)

    def csr(self, prog, i: int, half: bool = False):
        d = self.pool.pop(i) if i in self.pool else self.data(i)
        n, indptr, indices = self.n, self.indptr, self.indices
        if half:                      # a fault: the second half left out
            n = self.n // 2
            nnz = int(indptr[n])
            indptr, indices, d = indptr[:n + 1], indices[:nnz], d[:nnz]
        return prog.CSR(n, self.m, prog.Field(self.p), indptr, indices, d)


class Caller:
    """One call of the cell: the operation's `call` (its answers on the
    host, the device synchronized), its clocks kept, and the fault under
    test planted in its answers."""

    def __init__(self, op, prog, torch, opts, dev, p: int, fault=None):
        self.op, self.prog, self.torch = op, prog, torch
        self.opts, self.dev, self.p, self.fault = opts, dev, p, fault
        self.last = None
        self.clocks = {}

    def __call__(self, A) -> dict:
        out, clocks = self.op.call(self.prog, self.torch, A, self.opts,
                                   self.dev)
        for name, s in clocks.items():
            self.clocks.setdefault(name, []).append(s)
        f = self.fault
        if f == "stale":                     # the previous call's answers
            prev, self.last = self.last, out
            return out if prev is None else prev
        if f in (None, "half", "bf16"):      # planted before the call
            return out
        return self.op.plant(out, f, self.p)

    def launch(self, A) -> None:
        """The call's device work alone, where the operation has it (a
        whole call under `stale`, so that call 0 has answers to repeat)."""
        if hasattr(self.op, "launch") and self.fault != "stale":
            self.op.launch(self.prog, self.torch, A, self.opts, self.dev)
        else:
            self(A)


def bf16_products(torch, modp):
    """The control: the digit products in bfloat16 (exact operands, each
    result rounded to 8 significant bits) in place of int8 x int8 ->
    int32 on the tensor cores."""
    def mm(a, b):
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(torch.int32)
    modp._mm8 = mm


def power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="plant a fault or the lower-precision control "
                         "(the checks must then fail); never in a "
                         "benchmark run")
    return ap.parse_args(argv)


def main(argv, t_start: float, root: pathlib.Path = ROOT,
         data: pathlib.Path = BENCH, device=None) -> int:
    """Runs one cell; `device` other than None (a test) skips the look
    for a card."""
    args = parse(argv)
    cell = Cell(args.workload, root, data)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark: torch.cuda.is_available() is False: no card, "
                  "no result", file=sys.stderr)
            return 1
        if torch.cuda.device_count() < int(cell.cell["chips"]):
            print(f"benchmark: {torch.cuda.device_count()} cards, the cell "
                  f"needs {cell.cell['chips']}", file=sys.stderr)
            return 1
        device = "cuda:0"
    dev = torch.device(device)
    import spasm_tpu_torch as prog
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense import modp
    logging.getLogger("spasm_tpu_torch").setLevel(logging.WARNING)
    if dev.type == "cuda":
        _cuda.lib()                        # the kernels: built or loaded
    if args.fault == "bf16":
        bf16_products(torch, modp)
    inputs = Inputs(cell.matrix(), cell.prime, args.seed)
    opts = prog.EchelonizeOptions(**cell.mix["options"])
    caller = Caller(cell.operation(), prog, torch, opts, dev, cell.prime,
                    args.fault)
    half = args.fault == "half"
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    # set-up: the device work of one call of the cell's own kind, on an
    # input of its own (reading answers to the host warms nothing)
    t0 = time.perf_counter()
    caller.launch(inputs.csr(prog, -1, half))
    sync()
    warm_s = time.perf_counter() - t0
    caller.clocks = {}
    inputs.fill(1 + math.ceil(args.seconds / max(0.5 * warm_s, 1e-3)))
    setup_s = time.time() - t_start

    keep = CHECKED_CALLS
    rng_keep = np.random.default_rng([inputs.seed, 3])
    kept, calls = {}, []
    rec = None
    if args.trace:
        rec, peak = traced(cell, prog, torch, caller, inputs, dev, half,
                           TRACED_CALLS, kept, calls)
    else:
        w0 = time.perf_counter()
        i = 0
        while True:
            c0 = time.perf_counter()
            out = caller(inputs.csr(prog, i, half))
            sync()
            calls.append(time.perf_counter() - c0)
            # a reservoir sample of `keep` calls, drawn from the seed
            if i < keep:
                kept[i] = out
            else:
                j = int(rng_keep.integers(0, i + 1))
                if j < keep:
                    del kept[sorted(kept)[j]]
                    kept[i] = out
            del out
            i += 1
            if time.perf_counter() - w0 >= args.seconds:
                break
        window_s = time.perf_counter() - w0
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)

    # the program's state is gone; the reference checks the kept calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdicts = caller.op.check(cell, inputs, kept, dev, torch)
    check_s = time.perf_counter() - t_check
    worst = {}
    for got in verdicts:
        for name, v in got.items():
            worst[name] = max(worst.get(name, 0), int(v))
    failed = sum(any(v > 0 for v in got.values()) for got in verdicts)
    checks = {name: {"value": v, "limit": 0} for name, v in worst.items()}
    correct = bool(kept) and all(c["value"] <= c["limit"]
                                 for c in checks.values())

    metrics = {}
    if args.trace:
        for name, reader in cell.readers().items():
            v = reader.read(rec)
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": float(v), "unit": unit}
    else:
        e2e = {"call_s": window_s / len(calls), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.cell["chips"]) if dev.type == "cuda"
                   else 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(calls),
              "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        from . import tracing
        device_info["busy_s"] = tracing.busy_us(rec) / 1e6
        w = tracing.window(rec)
        device_info["window_s"] = (w[1] - w[0]) / 1e6 if w else 0.0
        result["breakdown"] = tracing.breakdown(rec)
    result["checks"] = checks

    route = [{k: v for k, v in kept[i].items() if k in ("r", "rounds")}
             for i in sorted(kept)]
    clocks = {k: [round(c, 4) for c in v] for k, v in caller.clocks.items()}
    print(f"benchmark: {cell.name} seed {args.seed}: {len(calls)} calls "
          f"{[round(c, 4) for c in calls]} s, warm-up {warm_s:.3f} s, "
          f"checked calls {sorted(kept)} in {check_s:.1f} s, route {route}, "
          f"launches {dict(_cuda.launches)}, host peak "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB, clocks "
          f"{clocks} s"
          + (f", {len(rec['events'])} events traced" if rec else ""),
          file=sys.stderr)
    if dev.type == "cuda":
        print(f"benchmark: card {power_line()}", file=sys.stderr)
    found = sorted({k.split(".")[0] for k in sys.modules}
                   & set(FORBIDDEN))
    if found:
        print(f"benchmark: the run loaded {found}: no result",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def traced(cell, prog, torch, caller, inputs, dev, half, ntraced, kept,
           calls):
    """Whole calls under torch.profiler (host and device); returns the
    record (tracing.py) and the device's peak memory.  The B1, B4 and
    int8-product launches' inputs are kept from a replay of each traced
    call's device work after the profile, so that the profiled window
    holds only the program's own work.  Every traced call is checked."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from . import tracing
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for i in range(ntraced):
            c0 = time.perf_counter()
            with record_function("bench/call"):
                kept[i] = caller(inputs.csr(prog, i, half))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            calls.append(time.perf_counter() - c0)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    t0 = time.perf_counter()
    rec = tracing.record_of(prof.profiler.kineto_results.events())
    t1 = time.perf_counter()
    store = {}
    with tracing.wrapped_kernels(store):
        for i in range(ntraced):
            caller.launch(inputs.csr(prog, i, half))
    t2 = time.perf_counter()
    rec["launches"] = tracing.launch_costs(store)
    print(f"benchmark: traced {ntraced} calls {[round(c, 3) for c in calls]}"
          f" s; record {t1 - t0:.1f} s, replay {t2 - t1:.1f} s, costs "
          f"{time.perf_counter() - t2:.1f} s", file=sys.stderr, flush=True)
    rec["clocks"] = {k: list(v[:ntraced]) for k, v in caller.clocks.items()}
    rec["ncalls"] = ntraced
    return rec, peak
