"""A checkout root whose BENCHMARK.json also holds the parked cells
(``portbench/parked.json``: cells taken out of the benchmark whose files
stay), so that the tests keep their files working for the PR that brings
them back."""

from __future__ import annotations

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spec_with_parked() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(ROOT, "portbench", "parked.json")) as f:
        parked = json.load(f)
    for section, entries in parked.items():
        spec[section] = spec[section] + entries
    return spec


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> str:
    """A directory holding that BENCHMARK.json; the cells' files are found
    in the package as ever."""
    root = tmp_path_factory.mktemp("bench_root")
    (root / "BENCHMARK.json").write_text(json.dumps(spec_with_parked()))
    return str(root)
