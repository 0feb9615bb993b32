"""The traced run's record: what the per-layer readers read.

One `torch.profiler` capture (host and device) over
whole calls, each inside a `bench/call` range, reduced to plain lists:

  rec["calls"]    [(start_us, end_us)] of the traced calls
  rec["kernels"]  [(name, start_us, end_us, correlation)] device events
                  (kernels, copies, fills), the profiler's annotations
                  left out
  rec["ranges"]   [(name, start_us, end_us)] host ranges named spasm/...
                  (the program's phases) or bench/... (this harness's)
  rec["events"]   the capture's raw events, for readers of host operators
                  (op_kernel_us); rec["launch_ids"] {thread: [(start_us,
                  correlation)]} the kernel launches
  rec["launches"] {"B1" | "B4" | "int_mm": [(bytes, ops)]}: one entry
                  per call of the wrapped kernels
  rec["clocks"]   {name: [seconds per traced call]}: this harness's clocks
  rec["ncalls"]   the number of traced calls

`union_us` and the window arithmetic are those of the repository's
profile_rank.py, copied so that they cannot move with the program.
"""
from __future__ import annotations

import contextlib

from . import roofline


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


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def window(rec):
    """(start_us, end_us) of the traced calls, or None."""
    if not rec["calls"]:
        return None
    return min(s for s, _ in rec["calls"]), max(e for _, e in rec["calls"])


def busy_us(rec) -> float:
    """Device busy time inside the traced window: the union of the
    device events, clipped to it."""
    w = window(rec)
    if w is None:
        return 0.0
    return union_us((max(s, w[0]), min(e, w[1])) for _, s, e, _ in rec["kernels"]
                    if e > w[0] and s < w[1])


def range_s_per_call(rec, name: str):
    """Host seconds per traced call inside ranges called `name` (nested
    ranges of one name counted once), or None where there is none."""
    spans = [(s, e) for n, s, e in rec["ranges"] if n == name]
    if not spans or not rec["ncalls"]:
        return None
    return union_us(spans) / 1e6 / rec["ncalls"]


def kernel_us(rec, keys) -> float:
    """Device time of the kernels whose names hold one of `keys`."""
    return sum(e - s for n, s, e, _ in rec["kernels"]
               if any(k in n for k in keys))


def roofline_pct(rec, launch_key: str, kernel_keys, ops_per_s: float):
    """100 x (least time of the recorded launches) / (their kernels'
    device time), or None where either is missing."""
    costs = rec["launches"].get(launch_key) or []
    t = kernel_us(rec, kernel_keys)
    if not costs or t <= 0:
        return None
    least = sum(roofline.least_s(b, o, ops_per_s) for b, o in costs)
    return 100.0 * least / (t / 1e6)


def breakdown(rec, top: int = 10) -> dict:
    """The heaviest device operations by name, and the longest idle gaps
    of the window summed by the innermost spasm/ range the host was in
    (bench/call where it was in none), both in seconds."""
    w = window(rec)
    by_op = {}
    for n, s, e, _ in rec["kernels"]:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda x: -x[1])[:top]
    gaps = {}
    if w is not None:
        busy = merged((max(s, w[0]), min(e, w[1])) for _, s, e, _ in
                      rec["kernels"] if e > w[0] and s < w[1])
        edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
        spans = sorted((s, e, n) for n, s, e in rec["ranges"]
                       if n.startswith("spasm/"))
        # sweep the gaps in order with a stack of the open ranges (host
        # ranges nest), so the innermost open range names each gap
        stack, i = [], 0
        for a, b in sorted(zip(edges[::2], edges[1::2])):
            if b <= a:
                continue
            mid = (a + b) / 2
            while i < len(spans) and spans[i][0] <= mid:
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            inner = [x for x in stack if x[1] > mid]
            name = inner[-1][2] if inner else "bench/call"
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}


def record_of(events, calls_name: str = "bench/call") -> dict:
    """The record of a capture's raw events (`prof.profiler.
    kineto_results.events()`: read without building the profiler's
    event tree, which takes minutes on a call of a million kernels); the
    caller adds launches, clocks and ncalls."""
    from torch.autograd import DeviceType
    rec = {"calls": [], "kernels": [], "ranges": [], "launches": {},
           "clocks": {}, "ncalls": 0}
    launch_ids = {}                  # thread -> [(start_us, correlation)]
    for e in events:
        name, s = e.name(), e.start_ns() / 1e3
        end = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                rec["kernels"].append((name, s, end, e.correlation_id()))
            continue
        if e.is_user_annotation() or name.startswith(("spasm/", "bench/")):
            if name == calls_name:
                rec["calls"].append((s, end))
            if name.startswith(("spasm/", "bench/")):
                rec["ranges"].append((name, s, end))
        elif name.startswith("cu") and e.correlation_id():
            # a CUDA runtime or driver call (cudaLaunchKernel, cuLaunch...)
            launch_ids.setdefault(e.start_thread_id(), []).append(
                (s, e.correlation_id()))
    rec["launch_ids"] = launch_ids
    rec["events"] = events
    return rec


def op_kernel_us(rec, op_name: str) -> float:
    """Device time of the kernels launched inside the host operators
    called `op_name` (launches matched to kernels by correlation id, on
    the operator's thread)."""
    import bisect
    dev = {}
    for _, s, e, corr in rec["kernels"]:
        dev[corr] = dev.get(corr, 0.0) + (e - s)
    launches = {t: sorted(v) for t, v in rec["launch_ids"].items()}
    starts = {t: [x for x, _ in v] for t, v in launches.items()}
    total = 0.0
    for ev in rec["events"]:
        if ev.name() != op_name or ev.is_user_annotation():
            continue
        s = ev.start_ns() / 1e3
        e, tid = s + ev.duration_ns() / 1e3, ev.start_thread_id()
        lv, st = launches.get(tid, []), starts.get(tid, [])
        i = bisect.bisect_left(st, s)
        while i < len(st) and st[i] <= e:
            total += dev.get(lv[i][1], 0.0)
            i += 1
    return total


@contextlib.contextmanager
def wrapped_kernels(store: dict):
    """Wraps the program's B1, B4 and int8-product entry points where its
    callers look them up (`dense.reduced.subst_waves`,
    `dense.panel.panel_pivots`, `dense.modp._mm8`) and keeps each call's
    inputs in `store` ("B1": schedules, "B4": copies of the panels,
    "int_mm": shapes), for `launch_costs`.  The copies are device work of
    the benchmark's own, so it wraps a replay of the traced calls after
    the profile is closed, never the profiled window."""
    from spasm_tpu_torch.dense import modp, panel, reduced
    subst0, panel0, mm0 = reduced.subst_waves, panel.panel_pivots, modp._mm8

    def subst(R, rows, ref_ptr, refs, coef, bounds, p):
        if R.device.type == "cuda" and R.dtype.itemsize == 2:
            store.setdefault("B1", []).append(
                (rows, ref_ptr, refs, coef, bounds, R.shape[1],
                 R.element_size()))
        return subst0(R, rows, ref_ptr, refs, coef, bounds, p)

    def pivots(P0, is_piv, p, nb, rref):
        if P0.device.type == "cuda":
            store.setdefault("B4", []).append(
                (P0.clone(), is_piv.clone(), p, rref))
        return panel0(P0, is_piv, p, nb, rref)

    def mm(a, b):
        if a.device.type == "cuda":
            store.setdefault("int_mm", []).append((tuple(a.shape),
                                                   tuple(b.shape)))
        return mm0(a, b)

    reduced.subst_waves, panel.panel_pivots, modp._mm8 = subst, pivots, mm
    try:
        yield
    finally:
        reduced.subst_waves, panel.panel_pivots = subst0, panel0
        modp._mm8 = mm0


def launch_costs(store: dict) -> dict:
    """{"B1" | "B4" | "int_mm": [(bytes, ops)]} of the kept calls."""
    out = {"int_mm": [roofline.int_mm_cost(s) for s in store.get("int_mm",
                                                                   [])]}
    for sched in store.get("B1", []):
        out.setdefault("B1", []).append(roofline.b1_cost(*sched))
    if store.get("B4"):
        out["B4"] = roofline.b4_costs(store["B4"])
    return out
