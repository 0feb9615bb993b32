"""Each per-layer reader on a small synthetic profiler record, and the
record built from raw profiler events."""
import pathlib

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, roofline, tracing

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"


class Ev:
    """Stands in for a raw profiler event (times in microseconds)."""

    def __init__(self, name, s, e, dev="cpu", corr=0, tid=1,
                 annotation=False):
        self._n, self._s, self._e, self._c = name, s, e, corr
        self._d = DeviceType.CUDA if dev == "cuda" else DeviceType.CPU
        self._t, self._a = tid, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int((self._e - self._s) * 1000)

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def synthetic():
    """Two calls of 100 us on the host; the device busy 60 us of them."""
    ev = [Ev("bench/call", 0, 100, annotation=True),
          Ev("bench/call", 100, 200, annotation=True),
          Ev("spasm/pivots", 0, 10, annotation=True),
          Ev("spasm/pivots", 100, 130, annotation=True),
          Ev("spasm/finish_device", 10, 90, annotation=True),
          Ev("spasm/finish_device", 130, 190, annotation=True),
          Ev("spasm/finish_dense", 20, 60, annotation=True),
          Ev("spasm/trailing_inverse", 30, 40, annotation=True),
          Ev("spasm/trailing_inverse", 35, 45, annotation=True),   # nested
          Ev("aten::_int_mm", 12, 14),
          Ev("cudaLaunchKernel", 12.5, 13, corr=901),
          Ev("aten::add", 15, 16),
          Ev("cudaLaunchKernel", 15.2, 15.4, corr=902),
          Ev("void subst_waves<Int16Arith>(short*, int)", 20, 40, "cuda",
             903),
          Ev("cutlass_80_wmma_tensorop_i161616gemm_s8", 40, 50, "cuda",
             901),
          Ev("elementwise_kernel", 50, 60, "cuda", 902),
          Ev("void panel_cluster<false>(int const*)", 150, 170, "cuda", 904),
          Ev("spasm/finish_device", 40, 50, "cuda", annotation=True)]
    rec = tracing.record_of(ev)
    rec["ncalls"] = 2
    rec["clocks"] = {"read": [0.25, 0.75]}
    rec["launches"] = {"B1": [(3.35e6, 1.0)],         # 1 us by bytes
                       "B4": [(0.0, 67e6)],           # 1 us by operations
                       "int_mm": [roofline.int_mm_cost([(64, 256),
                                                        (256, 128)])]}
    return rec


def read(name, rec):
    return harness.load_module(METRICS / f"{name}.py").read(rec)


def test_record_of_sorts_the_events():
    rec = synthetic()
    assert rec["calls"] == [(0, 100), (100, 200)]
    assert len(rec["kernels"]) == 4               # the annotation left out
    assert rec["launch_ids"] == {1: [(12.5, 901), (15.2, 902)]}
    assert tracing.window(rec) == (0, 200)
    assert tracing.union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_readers():
    rec = synthetic()
    assert read("device.idle_pct", rec) == pytest.approx(70.0)
    assert read("host.pivots_s", rec) == pytest.approx(20e-6)
    assert read("rank_finisher.span_s", rec) == pytest.approx(70e-6)
    assert read("dense_finisher.span_s", rec) == pytest.approx(20e-6)
    # nested ranges of one name count once: 30..45 us
    assert read("dense_finisher.trailing_inverse_s", rec) == \
        pytest.approx(7.5e-6)
    assert read("factors.materialize_s", rec) == pytest.approx(0.5)
    assert read("kernel.subst_roofline_pct", rec) == pytest.approx(5.0)
    assert read("kernel.panel_roofline_pct", rec) == pytest.approx(5.0)
    nbytes, ops = roofline.int_mm_cost([(64, 256), (256, 128)])
    least = roofline.least_s(nbytes, ops, roofline.INT8_OPS_PER_S)
    assert read("kernel.int8_mm_roofline_pct", rec) == \
        pytest.approx(100 * least / 10e-6)


def test_readers_find_nothing_and_return_none():
    rec = tracing.record_of([])
    rec["ncalls"] = 0
    for f in sorted(METRICS.glob("*.py")):
        assert harness.load_module(f).read(rec) is None, f.name


def test_breakdown_names_gaps_by_host_range():
    b = tracing.breakdown(synthetic())
    assert b["device_ops"][0] == ["void subst_waves<Int16Arith>(short*, "
                                  "int)", 20e-6]
    gaps = dict(b["idle_gaps"])
    assert gaps["spasm/finish_device"] == pytest.approx(50e-6)
    assert gaps["spasm/pivots"] == pytest.approx(90e-6)   # by its middle
    assert sum(gaps.values()) == pytest.approx(140e-6)


def test_roofline_costs():
    nbytes, ops = roofline.b1_cost([2, 3], [0, 1, 3], [0, 0, 2], [1, -1, 1],
                                   [0, 2], 64, 2)
    # rows 2, 3 and referenced row 0 read, rows 2, 3 written; 2 x 3 x 64
    assert nbytes == 5 * 64 * 2 + 4 * (2 + 2 + 3 + 6)
    assert ops == 2 * 3 * 64
    P0 = torch.zeros((8, 64), dtype=torch.int32)
    P0[0, 0] = 1
    P0[1, 0] = 2
    [(nb, ops)] = roofline.b4_costs([(P0, torch.zeros(8, dtype=torch.bool),
                                      42013, True)])
    assert nb == 8 * 64 * 4 + 16 + 64 * 5 + 64 * 64 * 4
    # one discovery step updates row 1 across the 63 later columns
    assert ops == 3 * 63 + 64 * 3 * 63 * 128 + 64 * 64


def discovery_ops_one_by_one(P0, is_piv, p, nb=64):
    """chip_smoke.py's `_b4_ops` discovery count, panel by panel."""
    Pw, piv, ops = P0.to(torch.int64), is_piv.clone(), 0
    for t in range(nb):
        col = Pw[:, t]
        avail = ~piv & (col != 0)
        if not bool(avail.any()):
            continue
        r = int(torch.argmax(avail.to(torch.int32)))
        g = torch.where(avail, col, 0)
        g[r] = 0
        ops += 3 * int((g != 0).sum()) * (nb - 1 - t)
        Pw = torch.remainder(col[r] * Pw - g[:, None] * Pw[r][None, :], p)
        piv[r] = True
    return ops


def test_b4_costs_batched_equal_one_by_one():
    gen = torch.Generator().manual_seed(5)
    panels = []
    for n in (10, 100, 100, 100, 300):
        P0 = torch.randint(-5, 6, (n, 64), generator=gen, dtype=torch.int32)
        P0 *= torch.rand((n, 64), generator=gen) < 0.1
        ip = torch.rand(n, generator=gen) < 0.3
        panels.append((P0, ip, 42013, bool(n % 20)))
    got = roofline.b4_costs(panels, batch=2)
    for (P0, ip, p, rref), (_, ops) in zip(panels, got):
        lu_extra = 0 if rref else (sum(2 * (63 - i) * 64 for i in range(64))
                                   + 64 * 64)
        fixed = sum(3 * (63 if rref else 63 - t) * 128 for t in range(64)) \
            + 64 * 64 + lu_extra
        assert ops - fixed == discovery_ops_one_by_one(P0, ip, p)
