"""On the card (skipped elsewhere): each cell's control, the reference in
the precision below its configuration's put in the program's place, fails
one of the cell's numbers at the cell's own size; each fault planted in
the timed path reads `correct` false. One seed each (the limits' readings
over many seeds come from calibrate.py; PERF.md lists them)."""
import pytest

from portbench import harness
from portbench.drivers.common import Cell
from portbench.faults import FAULTS
from portbench.reference import judge

CONTROLS = {"serve-bf16-volumes": "fp8", "serve-f32-volumes": "bf16"}


def _cell_run(name, device, control=None, seed=2 ** 31 + 101):
    cell = harness.find_cell(harness.spec(), name)
    run = Cell(name=name, config=cell["config"], traffic=cell["traffic"],
               limits=cell["limits"], seed=seed, seconds=2.0, device=device,
               control=control)
    return cell, run


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_card_control_is_not_correct(card, name):
    cell, run = _cell_run(name, card, CONTROLS[name])
    out = harness.driver_module(cell["driver"]).run(run)
    r = out["readings"]
    checks = [(k, r["controls"][CONTROLS[name]][k], limit)
              for k, limit in cell["limits"].items()]
    assert not judge.passed(checks), checks


@pytest.mark.parametrize("name,fault", [
    ("serve-bf16-volumes", "altered_answer"),
    ("serve-f32-volumes", "altered_answer")])
def test_card_fault_is_not_correct(card, name, fault):
    cell, run = _cell_run(name, card)
    with FAULTS[fault]():
        out = harness.driver_module(cell["driver"]).run(run)
    assert not judge.passed(out["checks"]), out["checks"]
