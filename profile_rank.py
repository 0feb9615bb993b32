#!/usr/bin/env python3
"""Device-time breakdown of the port's main paths on one NVIDIA card.

    python3 profile_rank.py [mk12.b4] [mk13.b5] [pluq16k] [mk12.b4.rounds]
                            [mk12.b4.pluq] [mk12.b4.wide] [pluq16k.wide]
                            (default: the first three)

Cases (the instances of chip_smoke.py): mk12.b4 and mk13.b5, ranked as
the rank tool orients them (the rank path's device finisher), pluq16k,
the complete PLUQ of synthetic_sparse(16000, 16000, 8, 42013) (bench.py
config 4; finish_dense in L mode), and mk12.b4.rounds, mk12.b4's rank
through the reference-shaped round loop (device_dense_width=0: round 0,
the sparse Schur complement through the reduced basis, round 1, then
finish_dense and its low-rank tail), and mk12.b4.pluq, its complete
PLUQ (the L-mode sparse Schur complement through the UEliminator, round
1, finish_dense in L mode); mk12.b4.wide and pluq16k.wide are mk12.b4
with default options and PLUQ16k's complete PLUQ at p = 2^32 - 5 (the
d = 4 tier: mk12.b4 takes the rounds there, its 20107 free columns
above the wide tiers' width cap), traced on the device alone
(ProfilerActivity.CUDA: no host events, so no `spasm/...` spans).  For
each: one warm-up call
of `echelonize(A, opts, device="cuda")`, three unprofiled warm calls
(their walls show the spread; one for the wide cases, ~a minute a
call), then one call under torch.profiler.  From
that profiled call alone it prints:
  - its wall (host clock around the call and a device synchronize);
  - device busy time: the union of the intervals of the device events
    (kernels, copies, fills), user annotations (the `spasm/...`
    record_function ranges, which the profiler books on the device too)
    left out;
  - the idle share 1 - busy / wall of that call (the profiler's own host
    overhead makes it an upper bound);
  - busy time by kernel group and the heaviest kernels;
  - the device span of each `spasm/...` range (first kernel start to
    last kernel end of the work launched inside it; nested ranges are
    counted in each), which places the groups in the engine's stages;
and, from one more call with SPASM_PROFILE_FINISH=1, the engine's stage
clocks (host clock, each stage closed by a device synchronize).
mk12.b4.pluq is not traced: torch.profiler's events of one call (several
million kernels) ran a 96 GiB host out of memory, so its device busy is
not measured here.

Imports nothing of JAX.
"""
import json
import logging
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPS = 3
UNTRACED = {"mk12.b4.pluq"}
DEVICE_ONLY = {"mk12.b4.wide", "pluq16k.wide"}
P4 = 4294967291
GROUPS = (("B1 subst_waves (int16 / int32)", ("subst_waves",)),
          ("B4 panel_cluster/panel_coop", ("panel_cluster", "panel_coop")),
          ("B2 sweep_cluster / sweep_find+sweep_update",
           ("sweep_cluster", "sweep_find", "sweep_update")),
          ("B3 tile_sweep", ("tile_sweep",)),
          ("int8 GEMM (torch._int_mm)", ("gemm", "cutlass", "igemm")),
          ("index/gather/scatter", ("index", "scatter", "gather")),
          ("copy/fill", ("copy", "fill", "memcpy", "memset", "Memcpy",
                         "Memset")))


def group(name: str) -> str:
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return "torch elementwise/reduce"


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def case(tag: str):
    """(A, opts, rank) of a case."""
    from spasm_tpu_torch import EchelonizeOptions
    from spasm_tpu_torch.gen import matching_complex_boundary, \
        synthetic_sparse
    if tag == "pluq16k":
        return (synthetic_sparse(16000, 16000, 8, 42013),
                EchelonizeOptions(complete=True), 15997)
    if tag == "pluq16k.wide":
        from spasm_tpu_torch import echelonize
        A = synthetic_sparse(16000, 16000, 8, P4)
        return (A, EchelonizeOptions(complete=True),
                echelonize(A, device="cuda").r)   # the rank path's rank
    opts, prime = None, 42013
    if tag == "mk12.b4.wide":
        tag, prime = "mk12.b4", P4
    if tag == "mk12.b4.rounds":
        tag, opts = "mk12.b4", EchelonizeOptions(device_dense_width=0)
    elif tag == "mk12.b4.pluq":
        tag, opts = "mk12.b4", EchelonizeOptions(complete=True)
    nn, j, want = {"mk12.b4": (12, 4, 39535),
                   "mk13.b5": (13, 5, 134211)}[tag]
    A = matching_complex_boundary(nn, j, prime)
    if A.n < A.m:                            # the rank tool's orientation
        A = A.transpose()
    return A, opts, want


def wall_of(echelonize, A, opts, want: int) -> float:
    return timed(echelonize, A, opts, want)[0]


def timed(echelonize, A, opts, want: int):
    """(wall, fact) of one call ending in a device synchronize."""
    t0 = time.time()
    fact = echelonize(A, opts, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    if fact.r != want:
        sys.exit(f"profile_rank: rank {fact.r} != {want}")
    return wall, fact


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("profile_rank: torch.cuda.is_available() is False")
    from spasm_tpu_torch import _cuda, echelonize
    logging.getLogger("spasm_tpu_torch").setLevel(logging.WARNING)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip(), flush=True)
    _cuda.lib()
    for tag in sys.argv[1:] or ["mk12.b4", "mk13.b5", "pluq16k"]:
        A, opts, want = case(tag)
        wall_of(echelonize, A, opts, want)         # warm-up
        reps = 1 if tag in DEVICE_ONLY else REPS
        walls = [wall_of(echelonize, A, opts, want) for _ in range(reps)]
        if tag not in UNTRACED:
            trace(tag, echelonize, A, opts, want, walls)
        else:
            print(f"== {tag} rank {want}: unprofiled warm walls {walls} s; "
                  "device busy not measured (not traced)", flush=True)
        os.environ["SPASM_PROFILE_FINISH"] = "1"
        wall, fact = timed(echelonize, A, opts, want)
        del os.environ["SPASM_PROFILE_FINISH"]
        print(f"   stage clocks of a call of {wall} s (synchronized): "
              + json.dumps({k: round(v, 4) for k, v in fact.profile.items()}),
              flush=True)
    return 0


def trace(tag, echelonize, A, opts, want: int, walls) -> None:
    """One call under torch.profiler: busy, idle share, groups, spans."""
    acts = [ProfilerActivity.CUDA]
    if tag not in DEVICE_ONLY:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        wall = wall_of(echelonize, A, opts, want)
    events = prof.events()
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    spans = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.is_user_annotation
                and e.name.startswith("spasm/")):
            n, t = spans.get(e.name, (0, 0.0))
            spans[e.name] = (n + 1, t + (e.time_range.end
                                         - e.time_range.start) / 1e6)
    busy = union_us((e.time_range.start, e.time_range.end)
                    for e in dev) / 1e6
    if busy > wall:
        sys.exit(f"profile_rank: busy {busy} s exceeds wall {wall} s")
    byg, byk = {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        byg[group(e.name)] = byg.get(group(e.name), 0.0) + us / 1e6
        n, t = byk.get(e.name, (0, 0.0))
        byk[e.name] = (n + 1, t + us / 1e6)
    kern_sum = sum(byg.values())
    print(f"== {tag} rank {want}: unprofiled warm walls "
          f"{walls} s; profiled call wall {wall} s, device busy "
          f"{busy} s over {len(dev)} device events, idle share "
          f"{1 - busy / wall}", flush=True)
    for g, v in sorted(byg.items(), key=lambda x: -x[1]):
        print(f"   {g:30s} {v:.4f} s  {100 * v / kern_sum:5.1f} %")
    for name, (n, t) in sorted(byk.items(), key=lambda x: -x[1][1])[:10]:
        print(f"   {1e3 * t:9.1f} ms n={n:6d} {name[:90]}")
    for name, (n, t) in sorted(spans.items(), key=lambda x: -x[1][1]):
        print(f"   range {name:28s} device span {t:.4f} s (n={n})")


if __name__ == "__main__":
    sys.exit(main())
