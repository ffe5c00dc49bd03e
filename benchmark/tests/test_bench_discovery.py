"""Cells, configurations, traffic, references and metric readers are found by name from files."""

import hashlib
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402

ROOT = harness.ROOT


def _hashes(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_every_cell_loads():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert harness.reference_module(cell).param_shapes(cell.config)
        assert {m["name"] for m in cell.per_layer} == {m["name"] for m in bench["per_layer"]}
        for m in cell.per_layer:
            assert callable(harness.metric_reader(cell, m["name"]).read)


def test_new_cell_and_metric_are_files(tmp_path):
    """A cell and a metric added as new files (and BENCHMARK.json entries) are
    found, and no file that was there is edited."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _hashes(root)
    wl = json.load(open(os.path.join(root, "benchmark", "workloads", "didbl-int8-fast512.json")))
    with open(os.path.join(root, "benchmark", "traffic", "frames256.json"), "w") as f:
        json.dump({"sizes": [[256, 256]], "pool": 4, "content": "rich", "loop": "closed", "clients": 1}, f)
    with open(os.path.join(root, "benchmark", "workloads", "didbl-int8-fast256.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "benchmark", "metrics", "window_seconds.py"), "w") as f:
        f.write("def read(run):\n    return run.window_s\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "didbl-int8-fast256", "config": "didbl", "traffic": "frames256",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "window_seconds", "unit": "s", "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "out_mpix_s"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = harness.load_cell("didbl-int8-fast256", root=root)
    assert cell.traffic["sizes"] == [[256, 256]] and cell.config["name"] == "didbl"
    assert "window_seconds" in {m["name"] for m in cell.per_layer}
    assert harness.metric_reader(cell, "window_seconds").read(harness._Run(None, {}, 2.5)) == 2.5
    after = _hashes(root)
    assert {k: v for k, v in after.items() if k in before} == before
