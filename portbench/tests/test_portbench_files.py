"""The benchmark's files: found by name, within the contract's characters
and lengths, and a new cell found from new files alone.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SPEC_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def with_parked(section: str) -> list:
    """The names of ``section``'s entries, the parked ones
    (``portbench/parked.json``) too."""
    with open(os.path.join(ROOT, "portbench", "parked.json")) as f:
        parked = json.load(f)
    return [e["name"] for e in spec()[section] + parked.get(section, [])]


@pytest.mark.parametrize("cell", with_parked("workloads"))
def test_every_cell_loads_by_name(cell, bench_root):
    c = harness.load_cell(cell, bench_root)
    assert c.traffic["config"] == c.config
    mod = c.program_module()
    assert callable(mod.Program) and callable(mod.follow)
    ref = importlib.import_module(f"portbench.reference.{harness.module_name(c.config)}")
    assert callable(ref.build) and callable(ref.Trainer)
    assert set(c.traffic["limits"]) <= set(__import__("portbench.check").check.NUMBERS)
    assert c.traffic["dtype"] in harness.CONTROL


@pytest.mark.parametrize("metric", with_parked("per_layer"))
def test_every_metric_reader_loads_by_name(metric):
    reader = importlib.import_module(f"portbench.metrics.{harness.module_name(metric)}")
    assert callable(reader.read)


def test_spec_keeps_to_the_contract():
    s = spec()
    assert set(s) == SPEC_KEYS
    assert len(s["command"]) <= 32 and all(LINE.match(w) for w in s["command"])
    assert s["paths"] == ["portbench"] and 1 <= s["run_seconds"] <= 51
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in s[sec]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert LINE.match(c["why"]) and LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in s["workloads"]}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later PR adds a workload file and an entry of BENCHMARK.json, and
    edits no file of the harness."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    s["workloads"].append({"name": "dcgan-64.extra", "config": "dcgan-64", "traffic": "extra",
                           "chips": 1, "why": "a cell added by files alone"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    with open(os.path.join(ROOT, "portbench", "workloads", "dcgan-64.graphed.json")) as f:
        traffic = json.load(f)
    traffic["steps_per_dispatch"] = 2
    (tmp_path / "portbench" / "workloads" / "dcgan-64.extra.json").write_text(json.dumps(traffic))
    code = ("from portbench import harness; c = harness.load_cell('dcgan-64.extra'); "
            "print(harness.HERE, c.traffic['steps_per_dispatch'], c.program_module().__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == [str(tmp_path / "portbench"), "2", "portbench.configs.dcgan_64"]
