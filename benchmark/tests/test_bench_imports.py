"""Nothing the harness runs loads JAX or the JAX package, and a run
without a card prints no result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from harness.guard import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

LOAD_ALL = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from pathlib import Path
import run, calibrate
from harness import guard, loop, peaks, program, roofline, spec, trace
bench = Path(sys.argv[2])
for d in ("traffic", "generators", "metrics", "reference"):
    for p in sorted((bench / d).glob("*.py")):
        spec.load_module(p, d)
import sprs_tpu_torch
print(json.dumps(sorted(sys.modules)))
"""


def test_guard_compares_whole_top_level_names():
    mods = {"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1, "sprs_tpu": 1, "sprs_tpu.formats": 1,
            "sprs_tpu_torch": 1, "sprs_tpu_torch.ops": 1, "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib", "sprs_tpu",
                                       "sprs_tpu.formats"]


def test_no_module_the_harness_imports_is_jax_or_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", LOAD_ALL, str(ROOT), str(BENCH)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert "sprs_tpu_torch" in names and "torch" in names
    assert forbidden_modules(dict.fromkeys(names)) == []


def test_no_source_of_the_harness_names_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        for line in p.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "sprs_tpu"), (p, line)


def test_a_run_without_a_card_exits_nonzero_with_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hpcg256.cg50", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
