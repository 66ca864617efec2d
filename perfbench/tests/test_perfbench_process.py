"""The run as a process: what it loads, and that with no card it fails
without printing a result."""

import os
import shutil
import subprocess
import sys

from perfbench.spec import ROOT

CPU_RUN = """
import dataclasses, sys, torch
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import run, spec
cell = spec.resolve("quickdraw-lstm.bulk")
t = dict(cell.traffic, events_per_call=8, pool_events=16, check_calls=1)
r = run.run_cell(dataclasses.replace(cell, traffic=t), 7, 0.2, False,
                 torch.device("cpu"))
assert r["correct"], r
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def env(**kw):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(CUDA_VISIBLE_DEVICES="", **kw)
    return e


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = CPU_RUN.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(out.stdout.split())
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_no_card_fails_without_a_result(tmp_path):
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "quickdraw-lstm.bulk", "--seed", str(2**31 + 1), "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, env=env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    # and in a directory that holds only BENCHMARK.json and perfbench/
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, env=env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
