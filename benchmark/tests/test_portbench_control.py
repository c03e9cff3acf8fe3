"""The control on the card, at a size a test run holds: the reference put
in the program's place in TF32 (the precision below the configuration's
float32 with TF32 off) must fail one of the cell's numbers by its limits.
Also run at each cell's own size by `benchmark/control.py`, which gave the
limits' upper readings (PERF.md)."""
import pytest

import control
from conftest import small_cell


@pytest.mark.card
@pytest.mark.parametrize("name", ["kd_train.tiny_h_d53.b16", "train.darknet53.b16",
                                  "serve.tiny_h.multi_b32"])
def test_the_control_fails_the_check(name, card):
    cell = small_cell(name)
    cell["name"] = name
    got = control.readings(cell, 4100000001, card)["control"]
    assert any(got[k] > lim for k, lim in cell["limits"].items()), got
