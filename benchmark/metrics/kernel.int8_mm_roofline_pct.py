"""kernel.int8_mm_roofline_pct: torch._int_mm (the digit products of
dense/modp.matmul_digits) as a share of its roofline: the least time of
the traced products (2 m n k over the int8 peak, or their bytes over
HBM, from the shapes the benchmark's wrapper of `_mm8` recorded) over
the device time of the kernels the `aten::_int_mm` calls launched."""
from benchmark import roofline, tracing


def read(rec):
    costs = rec["launches"].get("int_mm") or []
    dev_us = tracing.op_kernel_us(rec, "aten::_int_mm")
    if not costs or dev_us <= 0:
        return None
    least = sum(roofline.least_s(b, o, roofline.INT8_OPS_PER_S)
                for b, o in costs)
    return 100.0 * least / (dev_us / 1e6)
