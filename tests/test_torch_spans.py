"""The library's profiler spans (``sprs_tpu_torch/_span.py``, documented
in ``utils/profile.py``): which calls record which ``sprs.`` span under
a profiler, and that with no profiler running no span builds a
``record_function`` range and the results are unchanged.

Imports neither JAX nor the JAX package, so that the ``gpu`` test runs
on a card: ``python -m pytest --noconftest tests/test_torch_spans.py -q
-m gpu``.
"""

from __future__ import annotations

import ast
import collections
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from sprs_tpu_torch import linalg
from sprs_tpu_torch.formats.triplet import coo_to_csmat
from sprs_tpu_torch.ops import prod
from sprs_tpu_torch.ops.cuda.dia_spmv import dia_spmv_kernel
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_spmv_kernel
from sprs_tpu_torch.utils import profile

PACKAGE = Path(__file__).resolve().parents[1] / "sprs_tpu_torch"
SPANS = {"sprs.cg.sync", "sprs.k1", "sprs.k5", "sprs.index_sum", "sprs.coo_to_csmat",
         "sprs.prepare_spmv"}
# the spans the benchmark puts around its own calls into the library
BENCHMARK_SPANS = {"bench.window", "cg", "spmv", "pagerank", "build", "compress", "route"}


def laplacian(side: int, seed=None):
    """Triplets of the SPD 5-point Dirichlet Laplacian on side² unknowns;
    with ``seed``, the unknowns in a seeded order (routes to ELL)."""
    n = side * side
    ids = np.arange(n)
    ii, jj = np.divmod(ids, side)
    rows, cols, vals = [ids], [ids], [np.full(n, 4.0)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ok = (ii + di >= 0) & (ii + di < side) & (jj + dj >= 0) & (jj + dj < side)
        rows.append(ids[ok])
        cols.append(((ii + di) * side + jj + dj)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    if seed is not None:
        pos = np.random.default_rng(seed).permutation(n)
        r, c = pos[r], pos[c]
    return r, c, v, (n, n)


def hub(n: int = 200, seed: int = 5):
    """Triplets of a matrix with one full row and two random entries in
    every other, duplicates included: the CSR route."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.zeros(n, np.int64), np.repeat(np.arange(n), 2)])
    c = np.concatenate([np.arange(n), rng.integers(0, n, 2 * n)])
    return r, c, rng.standard_normal(r.size), (n, n)


def csmat(triplets, device="cpu"):
    r, c, v, shape = triplets
    return coo_to_csmat(r, c, v, shape, device=device)


def x_for(mat, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(mat.cols)).to(mat.device)


def recorded(fn, log_dir):
    """(fn(), Counter of the range names the Chrome trace of
    ``profile.trace`` holds)."""
    with profile.trace(str(log_dir)) as d:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with open(os.path.join(d, "trace.json")) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = collections.Counter(
        e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, names


@pytest.mark.parametrize("tol, max_iter, reads", [
    # max_iter reached: the loop tests max_iter times, then converged
    # and the residual norm: iterations + 2
    (0.0, 10, lambda it: it + 2),
    # converged: the loop tests once more than it iterates: iterations + 3
    (1e-8, 1000, lambda it: it + 3),
], ids=["max_iter", "converged"])
def test_cg_marks_each_host_read(tmp_path, tol, max_iter, reads):
    """One ``sprs.cg.sync`` per host read of a device value."""
    mat = csmat(laplacian(8))
    b = x_for(mat)
    res, names = recorded(
        lambda: linalg.cg(lambda v: prod.spmv(mat, v), b, tol=tol, max_iter=max_iter), tmp_path)
    assert res.converged == (tol > 0) and 0 < res.iterations <= max_iter
    assert names["sprs.cg.sync"] == reads(res.iterations)
    assert names["sprs.index_sum"] == res.iterations + 2  # one per matvec


def test_csr_product_and_assembly_spans(tmp_path):
    """``coo_to_csmat`` records its span with the index sum of its
    duplicates inside; ``prepare_spmv`` its span; a CSR product one
    ``sprs.index_sum``."""
    mat, names = recorded(lambda: csmat(hub()), tmp_path / "a")
    assert names["sprs.coo_to_csmat"] == 1 and names["sprs.index_sum"] == 1
    assert prod._route(mat) == "csr"
    (fn, prepared), names = recorded(lambda: prod.prepare_spmv(mat), tmp_path / "b")
    assert names["sprs.prepare_spmv"] == 1 and fn is prod.spmv
    x = x_for(mat)
    _, names = recorded(lambda: fn(prepared, x), tmp_path / "c")
    assert names["sprs.index_sum"] == 1 and names["sprs.prepare_spmv"] == 0


def test_ell_product_span_on_the_cpu(tmp_path):
    """A product through ``ell_spmv_kernel`` records ``sprs.k5`` once,
    here on its plain path."""
    mat = csmat(laplacian(16, seed=3))
    fn, prepared = prod.prepare_spmv(mat)
    assert fn is ell_spmv_kernel
    x = x_for(mat)
    _, names = recorded(lambda: [fn(prepared, x) for _ in range(3)], tmp_path)
    assert names["sprs.k5"] == 3


def _calls():
    """Each marked entry point on the CPU, as name -> thunk returning
    tensors and numbers to compare."""
    lap, perm, csr = (csmat(t) for t in (laplacian(8), laplacian(16, seed=3), hub()))

    def cg():
        res = linalg.cg(lambda v: prod.spmv(lap, v), x_for(lap), tol=1e-10, max_iter=100)
        return [res.x, res.iterations, res.converged, res.residual_norm]

    def prepared(mat):
        fn, op = prod.prepare_spmv(mat)
        return [fn(op, x_for(mat))]

    def assembled():
        m = csmat(hub())
        return [m.indptr, m.indices, m.data]

    return {"cg": cg, "spmv": lambda: [prod.spmv(csr, x_for(csr))], "coo_to_csmat": assembled,
            "prepare_spmv_dia": lambda: prepared(lap), "prepare_spmv_ell": lambda: prepared(perm),
            "prepare_spmv_csr": lambda: prepared(csr)}


@pytest.mark.parametrize("name", ["cg", "spmv", "coo_to_csmat", "prepare_spmv_dia",
                                  "prepare_spmv_ell", "prepare_spmv_csr"])
def test_no_range_is_built_without_a_profiler(monkeypatch, name):
    """With no profiler running, ``record_function`` is never called:
    patched to raise, every marked call still returns the bits of an
    unpatched call."""
    call = _calls()[name]
    want = call()

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function range was built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    got = call()
    for a, b in zip(want, got, strict=True):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    # the patch is what a span would call under a profiler
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler running"):
            profile.span("sprs.index_sum")


def test_span_names():
    """Every span the package opens is named by a literal with the
    ``sprs.`` prefix, none is a benchmark span's name, and they are the
    six that ``utils/profile.py`` documents."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), f"{path}: span name is not a literal"
                names.add(arg.value)
    assert names == SPANS
    assert all(n.startswith("sprs.") for n in names) and not names & BENCHMARK_SPANS
    doc = profile.__doc__
    assert all(f"``{n}``" in doc for n in names)


@pytest.mark.gpu
def test_kernel_spans_once_per_product_on_card(tmp_path):
    """On a card, ``sprs.k1`` (K1's direct launch) and ``sprs.k5`` appear
    once per product under the profiler, each with one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for triplets, kernel, span in ((laplacian(64), dia_spmv_kernel, "sprs.k1"),
                                   (laplacian(64, seed=3), ell_spmv_kernel, "sprs.k5")):
        mat = csmat(triplets, device="cuda")
        fn, prepared = prod.prepare_spmv(mat)
        x = x_for(mat)
        want = prod.spmv(mat, x)
        before = kernel.launches
        ys, names = recorded(lambda: [fn(prepared, x) for _ in range(4)], tmp_path / span)
        assert names[span] == 4 and kernel.launches - before == 4
        for y in ys:
            torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
