"""A configuration, a traffic mix and a per-layer metric added as new files
and entries alone: the harness finds each by its name in
``BENCHMARK.json`` and runs the new cell, and the new metric is read,
without a file of the benchmark edited."""

import json
import shutil

from conftest import BENCH, run_small, small_cell

NEW_METRIC = '''
def read(ctx):
    if ctx.get("loop") != "train":
        return None
    return float(ctx["steps"])
'''


def test_new_config_traffic_and_metric_are_files_alone(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

    # a configuration: its folder (a copy of the projected model's, n cut)
    # and its reference beside it
    cfg_dir = bench / "configs" / "plmc_small"
    shutil.copytree(bench / "configs" / "plmc_sarcos10k", cfg_dir)
    cfg = json.loads((cfg_dir / "config.json").read_text())
    cfg.update(name="plmc_small", n=200)
    (cfg_dir / "config.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "reference" / "plmc_sarcos10k.py",
                bench / "reference" / "plmc_small.py")
    plmc = next(c for c in spec["configs"] if c["name"] == "plmc_sarcos10k")
    spec["configs"].append(dict(plmc, name="plmc_small",
                                file="benchmark/configs/plmc_small/"
                                     "config.json"))
    # a traffic mix: parameters of the general training loop
    (bench / "traffic" / "train_short.json").write_text(json.dumps(
        {"loop": "train", "why": "short chunks", "scan_steps": 2,
         "warm_chunks": 1, "checked_steps": 2, "profile_chunks": 1}))
    name = "plmc_small.train_short"
    spec["workloads"].append({"name": name, "config": "plmc_small",
                              "traffic": "train_short", "chips": 1,
                              "why": "a test cell"})
    (bench / "limits" / f"{name}.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}))
    for m in spec["end_to_end"]:
        if "train_step_ms" == m["name"]:
            m["workloads"].append(name)
    # a per-layer metric: its reader
    (bench / "metrics" / "window_steps.train.py").write_text(NEW_METRIC)
    spec["per_layer"].append({"name": "window_steps.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "train_step_ms",
                              "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())

    cell = small_cell(name, root=root, bench=bench)
    assert cell.config["name"] == "plmc_small"
    assert cell.traffic["checked_steps"] == 2
    _, result = run_small(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["window_steps.train"]["value"] >= 2
