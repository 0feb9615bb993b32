"""kernel.panel_roofline_pct: kernel B4 (csrc/panel.cu, the panel step
of the column-sweep elimination) as a share of its roofline: the least
time of the traced launches (roofline.b4_cost, on each panel's own
data) over the device time of its panel_cluster / panel_coop kernels."""
from benchmark import roofline, tracing


def read(rec):
    return tracing.roofline_pct(rec, "B4", ("panel_cluster", "panel_coop"),
                                roofline.CORE_OPS_PER_S)
