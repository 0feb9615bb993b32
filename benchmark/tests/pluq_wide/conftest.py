"""The tiny stand-in of the cell `trefethen20kb.pluq.p4294967291`, added
to benchmark/tests/conftest.py's TINY_CONFIGS and TINY_CELLS as that
conftest is registered (`pytest_plugin_registered` is called
historically, so it reaches plugins registered before this one).  Its
configuration is Trefethen_600's (1, 1) minor, 599 x 599, whose complete
PLUQ sends a block of 311 x 311 to the dense LU (panel_steps at
2^32 - 5); its rank at that prime is written by the test that runs it
(test_bench_pluq_wide.py).  pytest loads this file when it collects
benchmark/tests as a whole (`python -m pytest benchmark/tests`)."""

NEW_TINY_CONFIGS = {
    "tref600b": {"generator": "trefethen_minor", "args": {"n": 600}},
}
NEW_TINY_CELLS = {             # tiny cell -> (config, traffic, the cell)
    "tref.pluq_wide": ("tref600b", "pluq.p4294967291",
                       "trefethen20kb.pluq.p4294967291"),
}


def pytest_plugin_registered(plugin, manager):
    confs = getattr(plugin, "TINY_CONFIGS", None)
    cells = getattr(plugin, "TINY_CELLS", None)
    if isinstance(confs, dict) and isinstance(cells, dict):
        for name, conf in NEW_TINY_CONFIGS.items():
            confs.setdefault(name, conf)
        for name, cell in NEW_TINY_CELLS.items():
            cells.setdefault(name, cell)
