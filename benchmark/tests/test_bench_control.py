"""The control, the plain reference at fp8 at use in the port's place,
comes out not correct at the cells' limits: the cell's miniature on the
CPU in bf16 (the configurations' precision), the readings the driver's
check would take. On the card the same control was read at each cell's
own size (PERF.md)."""

from __future__ import annotations

import pytest

from benchmark import common

SEED = 2 ** 36 + 5


@pytest.mark.parametrize("name", ["r50mem-eval-8x20", "r50mem-train-2x20"])
def test_control_is_not_correct(name):
    cell = common.miniature(common.find_cell(name))
    cell["config_file"]["overrides"]["compute_dtype"] = "bfloat16"
    kind = common.traffic_kind(cell)
    result, checks, extra = kind.run(cell, SEED, 0.5, False, True, "cpu")
    assert result["correct"] is True, checks
    control = extra["control"]
    assert any(control[k] > lim for k, (_, lim) in checks.items()), control
