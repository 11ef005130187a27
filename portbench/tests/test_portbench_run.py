"""`run.py` as the driver calls it, and the traffic mixes driving the port
on the CPU at 32^2 through the harness's result line."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import SERVE_SMALL, small_cell
from portbench import harness
from portbench.faults import FAULTS

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "serve-bf16-volumes", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("name", ["serve-bf16-volumes",
                                  "serve-f32-volumes"])
@pytest.mark.parametrize("trace", [False, True])
def test_mix_drives_the_port(name, trace):
    cell, run = small_cell(name, **SERVE_SMALL)
    run.trace = trace
    out = harness.driver_module(cell["driver"]).run(run)
    assert out["reference_setup_s"] > 0
    line = harness.result_line(cell, out, 1.0, trace, {"platform": "cpu",
                                                       "count": 1})
    print(json.dumps(line))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in (cell["per_layer"] if trace
                                 else cell["e2e"])}
    # device shares are left out off the card; everything else is read
    device_only = {"mfu_pct.serve", "device_idle_pct.serve",
                   "encoder_roofline_pct.serve"}
    assert set(line["metrics"]) == names - device_only
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(cell["limits"])


def test_serving_at_float32_agrees_with_the_reference():
    """The f32 program on the CPU computes the reference's math: the
    served labels are the reference's best wherever it is not a tie."""
    cell, run = small_cell("serve-f32-volumes", crop=64, **SERVE_SMALL)
    out = harness.driver_module(cell["driver"]).run(run)
    assert out["readings"]["widest_gap"] < 1e-3


@pytest.mark.parametrize("name,fault", [
    ("serve-bf16-volumes", "altered_answer"),
    ("serve-f32-volumes", "altered_answer")])
def test_a_planted_fault_is_not_correct(name, fault):
    """The run with the timed path broken underneath reads `correct`
    false against the cell's own limits (f32 on the CPU, where the
    program agrees with the reference, so only the fault shows)."""
    cell, run = small_cell(name, crop=64, dtype="float32", **SERVE_SMALL)
    with FAULTS[fault]():
        out = harness.driver_module(cell["driver"]).run(run)
    line = harness.result_line(cell, out, 1.0, False, {})
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("group,key,value", [
    ("encoder", "growth_rate", 48), ("decoder", "widths", [256, 128, 64, 32]),
    (None, "input_channels", 1), ("shape_stream", "res_width", 64)])
def test_a_width_the_builders_do_not_make_is_refused(group, key, value):
    """A configuration that states another width than the builders make,
    or a key they do not take, stops the run before anything is built."""
    from portbench.drivers.common import model_kwargs

    cell, run = small_cell("serve-bf16-volumes", **SERVE_SMALL)
    config = json.loads(json.dumps(cell["config"]))
    (config if group is None else config[group])[key] = value
    with pytest.raises(ValueError, match=key):
        model_kwargs(config)
    run.config = config
    with pytest.raises(ValueError, match=key):
        harness.driver_module(cell["driver"]).run(run)


def test_the_widths_the_builders_take_reach_both_sides():
    """num_filters is passed to the program and the reference alike: both
    then hold another parameter count than the published one, and the run
    stops on it."""
    from portbench.drivers.common import model_kwargs

    cell, run = small_cell("serve-f32-volumes", **SERVE_SMALL)
    assert model_kwargs(cell["config"]) == {
        "num_classes": 4, "num_filters": 32, "canny_low": 10.0,
        "canny_high": 100.0}
    run.config = dict(cell["config"], num_filters=16)
    with pytest.raises(ValueError, match="holds .* parameters"):
        harness.driver_module(cell["driver"]).run(run)
