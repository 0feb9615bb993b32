"""Structured tracing/profiling hooks.

Every engine phase is wrapped in a `torch.profiler.record_function`
range, so a trace captured with `torch.profiler` (or the `--profile DIR`
CLI flag) attributes the device kernels to engine phases.  The ranges
are entered only under an active profiler: otherwise a phase costs one
check.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
from typing import Iterator, Optional

import torch

log = logging.getLogger("spasm_tpu_torch")

_profiler: Optional[torch.profiler.profile] = None
_trace_dir: Optional[str] = None


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate a host-side engine phase on the profiler timeline as the
    range `spasm/<name>`; with no profiler active, nothing is recorded."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(f"spasm/{name}"):
        yield


def annotate(name: str):
    """Decorator form of `phase`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with phase(name):
                return fn(*a, **kw)
        return wrapper
    return deco


def start_trace(trace_dir: str) -> None:
    """Begin capturing a profiler trace: host activity, and the card's
    where CUDA is available."""
    global _profiler, _trace_dir
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    _profiler = torch.profiler.profile(activities=acts)
    _profiler.start()
    _trace_dir = trace_dir
    log.info("[trace] capturing profiler trace to %s", trace_dir)


def stop_trace() -> None:
    """End the capture and write trace_dir/trace.json (no-op without a
    start)."""
    global _profiler, _trace_dir
    if _profiler is None:
        return
    prof, path = _profiler, os.path.join(_trace_dir, "trace.json")
    _profiler = _trace_dir = None
    prof.stop()
    prof.export_chrome_trace(path)
    log.info("[trace] profiler trace written to %s", path)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace into trace_dir/trace.json when set."""
    if trace_dir is None:
        yield
        return
    start_trace(trace_dir)
    try:
        yield
    finally:
        stop_trace()
