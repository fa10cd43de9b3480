"""On a card (``python -m pytest benchmark/tests -q -m gpu``): a short
run of a cell prints a correct result line, and a directory that holds
only ``BENCHMARK.json`` and ``benchmark/`` gives no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cwd, cell="hpcg256.cg50", seconds="2", trace="0"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", seconds, "--trace", trace],
        cwd=cwd, capture_output=True, text=True, timeout=900)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    _card()
    out = _run(ROOT, trace=trace)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace == "1":
        assert r["device"]["busy_s"] > 0 and "hpcg_spmv_roofline" in r["metrics"]
        assert 0 < r["metrics"]["hpcg_spmv_roofline"]["value"] <= 105


@pytest.mark.gpu
def test_the_benchmark_alone_gives_no_result(tmp_path):
    _card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
