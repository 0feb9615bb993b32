"""kernel.subst_roofline_pct: kernel B1 (csrc/subst.cu, the int16
substitution sweep) as a share of its roofline: the least time of the
traced launches (bytes over HBM or operations over the CUDA cores, each
launch's schedule; roofline.b1_cost) over the device time of its
`subst_waves` kernels."""
from benchmark import roofline, tracing


def read(rec):
    return tracing.roofline_pct(rec, "B1", ("subst_waves",),
                                roofline.CORE_OPS_PER_S)
