"""BENCHMARK.json and the files it names keep to the benchmark's
contract: names, units, keys, files under ``benchmark/``, and a reader
for every metric; and a cell added as new files alone runs."""

import json
import shutil
import time

import pytest

from harness.loop import run_cell
from harness.spec import BENCH_DIR, SPEC_FILE, cell_metrics, load_cell, load_json, load_module, \
    valid_name, valid_unit

SPEC = load_json(SPEC_FILE)
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert valid_name(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith("benchmark/configs/")
    cfg = load_json(SPEC_FILE.parent / entry["file"])
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert valid_name(key) and key in cfg and key in cfg["reduced"]
        assert not key.endswith(("_dim", "_rank", "_size"))
    assert (BENCH_DIR / "generators" / f"{cfg['generator']}.py").exists()
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert valid_name(entry["name"]) and valid_name(entry["traffic"]) and _line(entry["why"])
    assert entry["chips"] in (1, 4)
    cell = load_cell(entry["name"])
    assert (BENCH_DIR / "traffic" / f"{cell.traffic['kind']}.py").exists()
    assert cell.limits and int(cell.workload["sample"]) >= 1
    e2e, layer = cell_metrics(SPEC, entry["name"])
    names = {m.name for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


def test_cells_are_unique_and_few_take_four_chips():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    assert 1 <= len(CELLS) <= 24
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    per_layer = m in SPEC["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(m) - {"workloads"} == keys
    assert valid_name(m["name"]) and valid_unit(m["unit"]) and m["better"] in ("lower", "higher")
    assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for w in m.get("workloads", []):
        assert w in CELLS
    if per_layer:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert m["workloads"]  # a per-layer metric names the cells it is read in
        for w in m["workloads"]:
            assert moved.get("workloads") is None or w in moved["workloads"]
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_setup_s_is_an_end_to_end_metric():
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_one_name_per_layer_spelling():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"solver loop", "assembly and routing", "wrappers", "kernels", "device"}


@pytest.mark.parametrize("path", sorted(
    p for d in ("configs", "workloads", "traffic") for p in (BENCH_DIR / d).glob("*.json")),
    ids=lambda p: f"{p.parent.name}/{p.name}")
def test_every_data_file_loads(path):
    data = load_json(path)
    assert isinstance(data, dict)
    assert all(valid_name(k) or k.replace(" ", "_").isidentifier() for k in data)
    if path.parent.name == "workloads":
        assert path.stem in CELLS and set(data) >= {"sample", "trace_requests", "limits"}


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "metrics").glob("*.py")), ids=lambda p: p.stem)
def test_every_metric_reader_loads(path):
    assert callable(load_module(path, "metric").read)
    assert any(m["name"] == path.stem for m in METRICS)


def test_a_new_cell_is_new_files_only(tmp_path):
    """A throwaway cell, its traffic mix and its limits, as new files in
    a copy of the benchmark: the harness finds and runs it unchanged."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "traffic" / "cg7.json").write_text(json.dumps(
        {"kind": "cg_sets", "iterations": 7, "numbering": "natural", "rhs_pool": 2}))
    (bench / "workloads" / "hpcg256.cg7.json").write_text(json.dumps(
        {"sample": 2, "trace_requests": 3, "limits": {"x_err": 1e-12, "resid_err": 1e-9}}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "hpcg256.cg7", "config": "hpcg256", "traffic": "cg7",
                              "chips": 1, "why": "a throwaway cell"})
    next(m for m in spec["end_to_end"] if m["name"] == "requests_per_s")["workloads"].append(
        "hpcg256.cg7")
    spec_file = tmp_path / "BENCHMARK.json"
    spec_file.write_text(json.dumps(spec))
    cell = load_cell("hpcg256.cg7", spec_file=spec_file, bench_dir=bench)
    cell.config = dict(cell.config, nx=5, ny=4, nz=6)
    assert cell.traffic["iterations"] == 7
    r = run_cell(cell, 7, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"requests_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
