"""What the span readers share: the program's host ranges with their
threads, and the device work the host launched inside them, from the
traced record (tracing.py: rec["events"], rec["launch_ids"],
rec["kernels"]).

A launch belongs to a range when the runtime call that made it (a
`cu...` call with a correlation id) starts inside the range on the
range's own thread; its device events are those of the same
correlation id.  Ranges of one name on one thread are merged first, so
nested entries of a name count once.
"""
from __future__ import annotations

import bisect

from . import tracing

COPY_PREFIXES = ("Memcpy", "Memset")       # device events that are no kernel


def _index(rec) -> dict:
    """{name: {thread: [(start_us, end_us)]}} of the host ranges named
    spasm/... and of the `aten::_int_mm` operators, built once a record."""
    idx = rec.get("_span_index")
    if idx is None:
        from torch.autograd import DeviceType
        idx = {}
        for ev in rec["events"]:
            name = ev.name()
            if not (name.startswith("spasm/") or name == "aten::_int_mm") \
                    or ev.device_type() == DeviceType.CUDA:
                continue
            s = ev.start_ns() / 1e3
            idx.setdefault(name, {}).setdefault(ev.start_thread_id(),
                                                []).append(
                (s, s + ev.duration_ns() / 1e3))
        rec["_span_index"] = idx
    return idx


def host_spans(rec, name: str) -> dict:
    """{thread: [[start_us, end_us]]}: the ranges called `name`, merged
    per thread (empty where there is none)."""
    return {t: tracing.merged(v) for t, v in _index(rec).get(name, {}).items()}


def launched_in(rec, name: str) -> set:
    """Correlation ids of the launches made inside the ranges called
    `name`."""
    out = set()
    for tid, spans in host_spans(rec, name).items():
        lv = sorted(rec["launch_ids"].get(tid, []))
        starts = [s for s, _ in lv]
        for s, e in spans:
            i = bisect.bisect_left(starts, s)
            while i < len(starts) and starts[i] <= e:
                out.add(lv[i][1])
                i += 1
    return out


def device_us(rec, corrs) -> float:
    """Device time of the events of the correlation ids `corrs`."""
    return sum(e - s for _, s, e, c in rec["kernels"] if c in corrs)


def kernel_ids(rec) -> set:
    """Correlation ids that name a kernel (no copy, no fill) in the
    device trace."""
    return {c for n, _, _, c in rec["kernels"]
            if not n.startswith(COPY_PREFIXES)}


def idle_us_inside(rec, name: str) -> float:
    """Microseconds inside the ranges called `name` in which no device
    event ran: each merged range less the union of the device events
    clipped to it."""
    busy = tracing.merged((s, e) for _, s, e, _ in rec["kernels"])
    starts = [s for s, _ in busy]
    spans = tracing.merged(iv for v in host_spans(rec, name).values()
                           for iv in v)
    idle = 0.0
    for a, b in spans:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0.0, min(busy[i][1], b) - max(busy[i][0], a))
            i += 1
        idle += (b - a) - covered
    return idle
