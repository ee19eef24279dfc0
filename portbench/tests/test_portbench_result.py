"""The result line: its keys, in order, and a run without a card that prints none."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", [tiny.GP, tiny.VJP])
def test_result_line_keys(name):
    result, lines = tiny.run(tiny.cell(name), seconds=0.5)
    assert list(result)[: len(KEYS)] == KEYS
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"} and math.isfinite(metric["value"])
    assert len(lines) == len(result["checks"])
    json.loads(json.dumps(result))


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", tiny.VJP, "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300, check=False)


def test_no_card_no_result():
    out = _run(tiny.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ (no program) prints no result."""
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
