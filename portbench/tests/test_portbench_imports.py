"""What the benchmark loads, and how it refuses to run: no JAX and no JAX
package in a run's process; the references load nothing of the port; no
result without the cards the cell asks for, nor without the port."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def python(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'dcgan-64.graphed', '--seed', '2200000001', '--seconds',"
        " '0.2', '--trace', '0'], device='cpu', look_for_chip=False,"
        " sizes={'cfg': {'img_size': 16, 'batch_size': 8}, 'traffic': {'steps_per_dispatch': 2}})\n"
        f"print(rc, {TOP})\n")
    p = python(code)
    assert p.returncode == 0, p.stderr[-2000:]
    rc, top = p.stdout.strip().splitlines()[-1].split(" ", 1)
    top = eval(top)
    assert rc == "0" and "tpugan_torch" in top
    assert not {"jax", "jaxlib", "flax", "tpugan"} & set(top)


def test_the_references_load_nothing_of_the_port():
    code = ("import sys, pkgutil, importlib, portbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__): importlib.import_module(f'{r.__name__}.{m.name}')\n"
            "import portbench.check, portbench.counting, portbench.trace, portbench.peaks\n"
            f"print({TOP})\n")
    p = python(code)
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "tpugan", "tpugan_torch"} & top


def test_no_result_without_cards():
    """This machine has no CUDA device: exit 2 and nothing on standard out."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "dcgan-64.graphed",
                        "--seed", "2200000003", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_beside_the_benchmark_alone(tmp_path):
    """A directory that holds BENCHMARK.json and the files under paths
    alone has no port to run. (An editable install of this repository
    would find the port from anywhere: its finder is taken out first.)"""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys\n"
            "sys.meta_path[:] = [f for f in sys.meta_path if '__editable__' not in repr(f)]\n"
            "sys.path[:] = [p for p in sys.path if '__editable__' not in p]\n"
            "from portbench import run\n"
            "sys.exit(run.main(['--workload', 'dcgan-64.graphed', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device='cpu', look_for_chip=False))\n")
    p = python(code, cwd=tmp_path, env=env)
    assert p.returncode != 0 and "tpugan_torch" in p.stderr
    assert not p.stdout.strip().startswith("{") and "correct" not in p.stdout
