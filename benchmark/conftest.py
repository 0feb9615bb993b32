"""pytest's hooks for the benchmark's tests (benchmark/tests): the tiny
stand-ins of the cells that benchmark/tests/conftest.py does not list.

That conftest builds a checkout-like tiny root from BENCHMARK.json,
renaming each per-layer metric's `workloads` from the real cells to
their stand-ins in its TINY_CELLS, so every cell a metric names needs a
stand-in there.  This file, loaded before it, adds the stand-ins of the
mk12.b4 cells as that conftest is registered.  Their configuration is
the tiny root's mk9.b3; the mix `rank_wide.tiny` is written by the
tests that run it (test_bench_mk12.py)."""

NEW_TINY_CELLS = {             # tiny cell -> (config, traffic, the cell)
    "mk12.rank": ("mk9.b3", "rank.tiny", "mk12b4.rank"),
    "mk12.wide": ("mk9.b3", "rank_wide.tiny", "mk12b4.rank.p4294967291"),
}


def pytest_plugin_registered(plugin, manager):
    cells = getattr(plugin, "TINY_CELLS", None)
    if isinstance(cells, dict):
        for name, cell in NEW_TINY_CELLS.items():
            cells.setdefault(name, cell)
