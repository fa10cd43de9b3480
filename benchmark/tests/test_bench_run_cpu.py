"""Whole runs of every cell at a tiny size on the CPU (the harness's
look for a card skipped): the program agrees with the plain reference;
the control (the program one precision lower) comes out not correct;
and so does each fault the cell can have, planted in the program under
the timed path: a step that returns its state unchanged, half of the
work left out, an answer altered where it is produced.  (No cell spans
chips, so no exchange between chips can be left out.)  A stale build is
caught on every seed, not on the seeds whose sample happens to hold a
build with new weights."""

import io
import time

import pytest
import torch

import sprs_tpu_torch
from calibrate import control_cell
from harness.loop import run_cell
from sprs_tpu_torch import linalg
from sprs_tpu_torch.ops import prod
from tiny import tiny_cell

CELLS = ["hpcg256.cg50", "hpcg256.cg50-perm", "kron23.pagerank", "kron23.build"]


def _run(cell, seed=20250101, trace=False):
    return run_cell(cell, seed, 0.3, trace, "cpu", time.perf_counter(), log=io.StringIO())


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_the_program_agrees_with_the_reference(name, trace):
    r = _run(tiny_cell(name), trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    if not trace:
        assert "setup_s" in r["metrics"]
        assert {"requests_per_s", "graph_requests_per_s"} & set(r["metrics"])


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, seed):
    r = _run(control_cell(tiny_cell(name)), seed=seed)
    assert not r["correct"], r["checks"]


def _cg_unchanged(mat, b, x0=None, **kw):
    return linalg.CgResult(torch.zeros_like(b), False, 0, float(torch.linalg.vector_norm(b)))


def _product_half(real):
    def prepare(mat):
        fn, prepared = real(mat)

        def half(p, x):
            y = fn(p, x).clone()
            y[y.shape[0] // 2:] = 0
            return y
        return half, prepared
    return prepare


def _product_unchanged(real):
    def prepare(mat):
        _, prepared = real(mat)
        return (lambda p, x: x.clone()), prepared
    return prepare


def _product_altered(real):
    def prepare(mat):
        fn, prepared = real(mat)

        def altered(p, x):
            y = fn(p, x).clone()
            y[y.shape[0] // 3] += 1e-3 * y.abs().max()
            return y
        return altered, prepared
    return prepare


def _cg_altered(real):
    def cg(*a, **kw):
        res = real(*a, **kw)
        res.x[res.x.shape[0] // 3] *= 1.0 + 1e-6
        return res
    return cg


def _build_stale(real):
    first = {}

    def build(rows, cols, data, shape, **kw):
        return first.setdefault("mat", real(rows, cols, data, shape, **kw))
    return build


def _build_half(real):
    def build(rows, cols, data, shape, **kw):
        h = rows.shape[0] // 2
        return real(rows[:h], cols[:h], data[:h], shape, **kw)
    return build


def _route_altered(real):
    def prepare(mat):
        from sprs_tpu_torch.formats.ell import ell_from_csmat

        fn, _ = real(mat)
        return fn, ell_from_csmat(mat)
    return prepare


def _build_altered(real):
    def build(*a, **kw):
        mat = real(*a, **kw)
        mat.data[mat.data.shape[0] // 3] *= 1.0 + 1e-3
        return mat
    return build


FAULTS = {
    "hpcg256.cg50": {
        "state unchanged": (linalg, "cg", lambda real: _cg_unchanged),
        "half the rows": (prod, "prepare_spmv", _product_half),
        "answer altered": (linalg, "cg", _cg_altered),
    },
    "kron23.pagerank": {
        "state unchanged": (prod, "prepare_spmv", _product_unchanged),
        "half the rows": (prod, "prepare_spmv", _product_half),
        "answer altered": (prod, "prepare_spmv", _product_altered),
    },
    "kron23.build": {
        "state unchanged": (sprs_tpu_torch, "coo_to_csmat", _build_stale),
        "half the triplets": (sprs_tpu_torch, "coo_to_csmat", _build_half),
        "answer altered": (sprs_tpu_torch, "coo_to_csmat", _build_altered),
        "route altered": (prod, "prepare_spmv", _route_altered),
    },
}
FAULTS["hpcg256.cg50-perm"] = FAULTS["hpcg256.cg50"]
CASES = [(c, f) for c in CELLS for f in FAULTS[c]]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_fault_in_the_program_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    owner, attr, breaker = FAULTS[name][fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    r = _run(cell)
    assert r["failed"] == 0  # every request answered: the check's numbers catch the fault
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_a_stale_build_is_not_correct_on_every_seed(seed, monkeypatch):
    monkeypatch.setattr(sprs_tpu_torch, "coo_to_csmat", _build_stale(sprs_tpu_torch.coo_to_csmat))
    r = _run(tiny_cell("kron23.build"), seed=seed)
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]
