"""The two readers of the block combine's range (`ref_combine.device_s`,
`ref_combine.launches`) in whole traced runs of the tiny stand-ins of
the mk12.b4 cells on the CPU: both report in the wide cell and in the
d = 2 control, and the CPU tensors launch no kernel there."""
from test_bench_mk12 import wide_root  # noqa: F401  (the fixture)
from test_bench_run import cell_args, run

METRICS = {"ref_combine.device_s", "ref_combine.launches"}


def test_wide_cell_reports_the_combine(wide_root, capsys):  # noqa: F811
    rc, res, _ = run(wide_root, capsys,
                     *cell_args("mk12.wide", 2 ** 33 + 7, 1))
    assert rc == 0 and res["correct"] is True
    assert METRICS <= set(res["metrics"])
    assert res["metrics"]["ref_combine.launches"]["unit"] == "launches"
    assert res["metrics"]["ref_combine.device_s"]["unit"] == "s"


def test_rows_cell_reports_the_combine(wide_root, capsys):  # noqa: F811
    rc, res, _ = run(wide_root, capsys, *cell_args("mk12.rank", 15, 1))
    assert rc == 0 and res["correct"] is True
    assert METRICS <= set(res["metrics"])
    # the d = 2 loop on CPU tensors: the range is there, no kernel in it
    assert res["metrics"]["ref_combine.launches"]["value"] == 0


def test_untraced_run_reports_no_combine(wide_root, capsys):  # noqa: F811
    rc, res, _ = run(wide_root, capsys,
                     *cell_args("mk12.wide", 2 ** 31 + 11, 0))
    assert rc == 0 and res["correct"] is True
    assert not METRICS & set(res["metrics"])
