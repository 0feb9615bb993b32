"""The span readers (benchmark/spans.py and the metrics that use it) on
a synthetic profiler record with two threads, and in a traced run of
the tiny cells on the CPU."""
import pytest

from benchmark import spans, tracing
from test_bench_metrics import Ev, read, synthetic
from test_bench_run import cell_args, run

NEW = ("factors.u_span_s", "factors.l_span_s", "rank_finisher.idle_s",
       "modp.digit_passes_s", "dense_finisher.trailing_inverse_launches")


def record():
    """Two calls of 100 us; thread 2 launches beside thread 1."""
    a = dict(annotation=True)
    ev = [Ev("bench/call", 0, 100, **a), Ev("bench/call", 100, 200, **a),
          Ev("spasm/finish_device", 10, 90, **a),
          Ev("spasm/finish_device", 110, 190, **a),
          Ev("spasm/factors_u", 60, 80, **a),
          Ev("spasm/factors_l", 85, 95, **a),
          # the digit matmul: a nested entry, one _int_mm inside it
          Ev("spasm/matmul_digits", 11, 30, **a),
          Ev("spasm/matmul_digits", 12, 20, **a),
          Ev("aten::_int_mm", 12, 14),
          Ev("cudaLaunchKernel", 12.5, 13, corr=901),
          Ev("cudaLaunchKernel", 15.2, 15.4, corr=902),
          Ev("cudaLaunchKernel", 16, 16.5, corr=905, tid=2),
          # the trailing inverse: a kernel, a copy, a launch with no
          # device event, and a nested entry
          Ev("spasm/trailing_inverse", 130, 140, **a),
          Ev("spasm/trailing_inverse", 135, 145, **a),
          Ev("cudaLaunchKernel", 131, 131.5, corr=906),
          Ev("cudaMemcpyAsync", 132, 132.5, corr=907),
          Ev("cudaLaunchKernel", 133, 133.5, corr=908),
          Ev("cudaLaunchKernel", 139, 139.5, corr=909),
          Ev("cudaLaunchKernel", 142, 142.5, corr=910),
          Ev("cudaLaunchKernel", 147, 147.5, corr=911),
          # device events
          Ev("cutlass_80_wmma_tensorop_i161616gemm_s8", 20, 40, "cuda",
             901),
          Ev("elementwise_kernel", 50, 60, "cuda", 902),
          Ev("elementwise_kernel", 62, 67, "cuda", 905),
          Ev("void panel_cluster<false>(int const*)", 150, 170, "cuda",
             904),
          Ev("elementwise_kernel", 170, 171, "cuda", 906),
          Ev("Memcpy DtoH (Device -> Pageable)", 171, 172, "cuda", 907),
          Ev("elementwise_kernel", 172, 173, "cuda", 909),
          Ev("elementwise_kernel", 173, 174, "cuda", 910),
          Ev("elementwise_kernel", 174, 175, "cuda", 911)]
    rec = tracing.record_of(ev)
    rec["ncalls"] = 2
    return rec


def test_host_spans_and_launches():
    rec = record()
    assert spans.host_spans(rec, "spasm/matmul_digits") == {1: [[11, 30]]}
    assert spans.launched_in(rec, "spasm/matmul_digits") == {901, 902}
    assert spans.launched_in(rec, "aten::_int_mm") == {901}
    assert spans.launched_in(rec, "spasm/trailing_inverse") == \
        {906, 907, 908, 909, 910}
    assert 907 not in spans.kernel_ids(rec)
    assert spans.host_spans(rec, "spasm/nothing") == {}


def test_readers():
    rec = record()
    assert read("factors.u_span_s", rec) == pytest.approx(10e-6)
    assert read("factors.l_span_s", rec) == pytest.approx(5e-6)
    # 80 us less 20 + 10 + 5 busy, and 80 us less 20 + 5 busy
    assert read("rank_finisher.idle_s", rec) == pytest.approx(
        (45 + 55) / 2 * 1e-6)
    # kernel 902 alone: 901 is the _int_mm's, 905 another thread's
    assert read("modp.digit_passes_s", rec) == pytest.approx(5e-6)
    # 906, 909, 910: 907 is a copy, 908 ran nothing, 911 came after
    assert read("dense_finisher.trailing_inverse_launches", rec) == 1.5


def test_readers_return_none_where_the_span_is_absent():
    rec = synthetic()       # the parent's spans: no factors or digit ranges
    for name in ("factors.u_span_s", "factors.l_span_s",
                 "modp.digit_passes_s"):
        assert read(name, rec) is None, name
    assert read("rank_finisher.idle_s", rec) is not None
    empty = tracing.record_of([])
    empty["ncalls"] = 0
    for name in NEW:
        assert read(name, empty) is None, name


@pytest.mark.parametrize("workload,found", [
    ("mk.rank", {"factors.u_span_s", "rank_finisher.idle_s",
                 "modp.digit_passes_s"}),
    ("tref.pluq", {"factors.u_span_s", "factors.l_span_s",
                   "modp.digit_passes_s"})])
def test_traced_run_reports_the_span_metrics(tiny_root, capsys, workload,
                                             found):
    rc, res, _ = run(tiny_root, capsys, *cell_args(workload, 2**31 + 3, 1))
    assert rc == 0 and res["correct"] is True
    got = {k for k in res["metrics"] if k in NEW}
    assert found <= got
    for k in found:
        assert res["metrics"][k]["value"] >= 0
    # no device on the CPU: the digit passes read no device time
    assert res["metrics"]["modp.digit_passes_s"]["value"] == 0.0
