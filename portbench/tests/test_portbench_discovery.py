"""A configuration, a traffic mix, a limits file and a per-layer metric
dropped into a copy of the benchmark are found by their names in
BENCHMARK.json, with no edit to run.py or the harness."""
import json
import shutil
from pathlib import Path

import torch

from portbench import harness
from portbench.drivers.common import Cell

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_dir = tmp_path / "portbench"
    config = json.loads((bench_dir / "configs" /
                         "saunet-acdc256-f32.json").read_text())
    config.update(name="saunet-acdc32-f32", crop_size=32)
    (bench_dir / "configs" / "saunet-acdc32-f32.json").write_text(
        json.dumps(config))
    mix = json.loads((bench_dir / "traffic" /
                      "volumes-z6to18.json").read_text())
    mix.update(pool_volumes=3, z_min=2, z_max=4, calibration_slices=4,
               checked_volumes=2, warmup_rounds=1, profile_volumes=1)
    (bench_dir / "traffic" / "volumes-z2to4.json").write_text(
        json.dumps(mix))
    (bench_dir / "limits" / "serve-f32-tiny.json").write_text(
        json.dumps({"mean_gap": 0.001}))
    (bench_dir / "metrics" / "volumes_seen.serve.py").write_text(
        'def read(record):\n    return float(len(record["slices"]))\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "saunet-acdc32-f32", "source": "test",
                             "file": "portbench/configs/"
                                     "saunet-acdc32-f32.json",
                             "reduced": ["crop_size"], "why": "test"})
    bench["workloads"].append({"name": "serve-f32-tiny",
                               "config": "saunet-acdc32-f32",
                               "traffic": "volumes-z2to4", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "serve-f32-volumes" in m["workloads"]:
            m["workloads"].append("serve-f32-tiny")
    bench["per_layer"].append({"name": "volumes_seen.serve",
                               "unit": "volumes", "better": "higher",
                               "source": "program_counter",
                               "layer": "client",
                               "moves": "serve_slices_per_s",
                               "workloads": ["serve-f32-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(harness.spec(tmp_path), "serve-f32-tiny",
                             tmp_path)
    assert cell["config"]["crop_size"] == 32
    assert cell["traffic"]["z_max"] == 4
    assert "volumes_seen.serve" in {m["name"] for m in cell["per_layer"]}
    run = Cell(name="serve-f32-tiny", config=cell["config"],
               traffic=cell["traffic"], limits=cell["limits"], seed=5,
               seconds=0.3, trace=True, device=torch.device("cpu"))
    out = harness.driver_module(cell["driver"]).run(run)
    line = harness.result_line(cell, out, 1.0, True, {}, tmp_path)
    assert line["metrics"]["volumes_seen.serve"]["value"] == \
        out["attempted"]
    assert line["metrics"]["volumes_seen.serve"]["unit"] == "volumes"
