"""modp.digit_passes_s: device seconds per call of the work launched
inside the program's `spasm/matmul_digits` ranges (dense/modp: the digit
split, pads, reductions and recombination), less the kernels launched by
`aten::_int_mm` (the int8 products, read by kernel.int8_mm_roofline_pct);
launches matched to device events by correlation id on the range's
thread."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/matmul_digits") or not rec["ncalls"]:
        return None
    corrs = spans.launched_in(rec, "spasm/matmul_digits") \
        - spans.launched_in(rec, "aten::_int_mm")
    return spans.device_us(rec, corrs) / 1e6 / rec["ncalls"]
