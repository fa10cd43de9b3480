"""The heat example's operator and solver as the benchmark's
``poisson2d4096.bicgstab50`` cell runs them, on the CPU at small sizes:
``utils.grid_laplacian`` built on the tensor's device, array for array
the numpy build it replaced; ``linalg.bicgstab`` through ``prepare_spmv``
against the benchmark's plain reference (``benchmark/reference/``,
loaded by path); and the ``sprs.bicgstab.sync`` span.

Imports neither JAX nor the JAX package, so that the ``gpu`` test runs
on a card: ``python -m pytest --noconftest
tests/test_torch_heat_bicgstab.py -q -m gpu``.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from sprs_tpu_torch import linalg
from sprs_tpu_torch.formats.csmat import csmat
from sprs_tpu_torch.ops import prod
from sprs_tpu_torch.utils import grid_laplacian, profile, special

REFERENCE = Path(__file__).resolve().parents[1] / "benchmark" / "reference"
SHAPES = [(1, 9), (9, 1), (1, 1), (2, 2), (3, 3), (2, 7), (5, 7), (12, 12), (33, 64)]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"heat_reference_{name}", REFERENCE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference_bicgstab = _load("bicgstab").bicgstab
Stencil5 = _load("stencil5").Stencil5


def numpy_grid_laplacian(shape, dtype):
    """The host build ``grid_laplacian`` had before: numpy meshgrid,
    ``lexsort`` and ``add.at``, then a copy to the device."""
    nx, ny = shape
    n = nx * ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    interior = ((ii > 0) & (ii < nx - 1) & (jj > 0) & (jj < ny - 1)).ravel()
    row = (ii * ny + jj).ravel()
    rows, cols, vals = [row], [row], [np.where(interior, 4.0, 1.0)]
    r_int = row[interior]
    for off in (-ny, -1, 1, ny):
        rows.append(r_int)
        cols.append(r_int + off)
        vals.append(np.full(r_int.size, -1.0))
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return csmat((n, n), np.cumsum(indptr).astype(np.int32), cols.astype(np.int32),
                 torch.from_numpy(vals).to(dtype), validate=False, device="cpu")


def _same_arrays(a, b):
    assert a.shape == b.shape and a.storage == b.storage
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.data, b.data)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_laplacian_equals_the_numpy_build(shape, dtype):
    _same_arrays(grid_laplacian(shape, dtype, device="cpu"), numpy_grid_laplacian(shape, dtype))


def test_grid_laplacian_uses_no_host_arrays(monkeypatch):
    """The construction never touches numpy: with the module's numpy replaced
    by nothing, it still gives the same arrays."""
    want = numpy_grid_laplacian((12, 12), torch.float64)
    monkeypatch.setattr(special, "np", None)
    _same_arrays(grid_laplacian((12, 12), device="cpu"), want)


@pytest.mark.parametrize("shape", [(32, 48), (1, 5), (2, 2), (5, 7)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_stencil_equals_the_program_operator(shape):
    """The reference's shifted slices and the CsMat product sum the same
    five terms in different orders: equal to a few ulps of the 4·u term."""
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, shape[0] * shape[1]))
    want = prod.spmv(grid_laplacian(shape, device="cpu"), x)
    torch.testing.assert_close(Stencil5(*shape).matvec(x), want, rtol=0, atol=1e-14)


def _rhs(seed: int, n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=g, dtype=torch.float64) * 2.0 - 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bicgstab_sets_of_50_against_the_reference(seed):
    """50 iterations at tolerance 0 on the 32 × 48 heat operator, as the
    cell's sets run them.  Handed the reference's own operator, the
    program's loop does the reference's arithmetic in its order: the same
    bits.  Through ``prepare_spmv`` the products sum in another order,
    and BiCGSTAB amplifies that last bit about 10^4.5 times every 10
    iterations, so x differs by up to about 1 % after 50 (measured
    3e-4 to 6e-3 here); what is compared there is what stays exact to
    rounding, as the benchmark's check does: the reported residual is
    that of the returned x (b − A·x is about 1 % of b, so its rounding
    is about 1e-13 of it: rtol 1e-10).  At these fixed seeds the residual
    is also within a factor 2 of the reference's (measured within 5 %;
    an x = 0 answer reads about 2,000 times it); the benchmark bounds no
    residual, since a sound set may end on a passing spike of it."""
    shape = (32, 48)
    ref = Stencil5(*shape)
    b = _rhs(seed, ref.n)
    x_ref, it_ref, r_ref = reference_bicgstab(ref.matvec, b, 0.0, 50)
    same = linalg.bicgstab(ref.matvec, b, tol=0.0, max_iter=50)
    assert torch.equal(same.x, x_ref) and same.iterations == it_ref == 50
    assert same.residual_norm == r_ref and not same.converged

    fn, prepared = prod.prepare_spmv(grid_laplacian(shape, device="cpu"))
    assert type(prepared).__name__ == "DiaTiledMat"
    res = linalg.bicgstab(lambda v: fn(prepared, v), b, tol=0.0, max_iter=50)
    true = float(torch.linalg.vector_norm(b - ref.matvec(res.x)))
    assert res.iterations == 50 and not res.converged
    assert res.residual_norm == pytest.approx(true, rel=1e-10)
    assert 0.5 < true / r_ref < 2.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bicgstab_solve_to_1e8_against_the_reference(seed):
    """A solve to the deployment's tolerance 1e-8 through
    ``prepare_spmv``: both converge, the program's true residual passes
    1e-8·‖b‖ by the reference's operator, and x agrees with the
    reference's to 1e-5 of max|x|: each is within cond(A)·1e-8 of the
    solution, and the 32 × 48 operator's condition number is about 600
    (measured 4e-8 to 2e-7).  The iteration counts differ by a few
    (measured 0 to 3): the last steps follow rounding."""
    shape = (32, 48)
    ref = Stencil5(*shape)
    b = _rhs(seed, ref.n)
    x_ref, it_ref, r_ref = reference_bicgstab(ref.matvec, b, 1e-8, 1000)
    fn, prepared = prod.prepare_spmv(grid_laplacian(shape, device="cpu"))
    res = linalg.bicgstab(lambda v: fn(prepared, v), b, tol=1e-8, max_iter=1000)
    b_norm = float(torch.linalg.vector_norm(b))
    assert res.converged and r_ref <= 1e-8 * b_norm
    assert float(torch.linalg.vector_norm(b - ref.matvec(res.x))) <= 1e-8 * b_norm
    assert abs(res.iterations - it_ref) <= 10
    err = float((res.x - x_ref).abs().max() / x_ref.abs().max())
    assert err < 1e-5


def _recorded(fn, log_dir):
    with profile.trace(str(log_dir)) as d:
        out = fn()
    with open(os.path.join(d, "trace.json")) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return out, collections.Counter(
        e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")


@pytest.mark.parametrize("tol, max_iter, reads", [
    # max_iter reached: the loop tests max_iter times, then converged and
    # the residual norm: iterations + 2
    (0.0, 10, lambda it: it + 2),
    # converged: the loop tests once more than it iterates: iterations + 3
    (1e-8, 1000, lambda it: it + 3),
], ids=["max_iter", "converged"])
def test_bicgstab_marks_each_host_read(tmp_path, tol, max_iter, reads):
    """One ``sprs.bicgstab.sync`` per host read of a device value."""
    mat = grid_laplacian((8, 8), device="cpu")
    b = _rhs(3, 64)
    res, names = _recorded(
        lambda: linalg.bicgstab(lambda v: prod.spmv(mat, v), b, tol=tol, max_iter=max_iter),
        tmp_path)
    assert res.converged == (tol > 0) and 0 < res.iterations <= max_iter
    assert names["sprs.bicgstab.sync"] == reads(res.iterations)
    assert names["sprs.cg.sync"] == 0


def test_bicgstab_builds_no_range_without_a_profiler(monkeypatch):
    """With no profiler running the span is the shared no-op: patched to
    raise, ``record_function`` is never called and the solve gives the
    bits of an unpatched one."""
    mat = grid_laplacian((8, 8), device="cpu")
    b = _rhs(4, 64)

    def solve():
        return linalg.bicgstab(lambda v: prod.spmv(mat, v), b, tol=1e-10, max_iter=100)

    want = solve()

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function range was built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got = solve()
    assert torch.equal(got.x, want.x)
    assert (got.iterations, got.converged, got.residual_norm) == (
        want.iterations, want.converged, want.residual_norm)


@pytest.mark.gpu
def test_grid_laplacian_builds_on_the_card():
    """On a card the operator is built there, with the CPU build's arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape in SHAPES:
        mat = grid_laplacian(shape, device="cuda")
        assert mat.indptr.is_cuda and mat.indices.is_cuda and mat.data.is_cuda
        _same_arrays(mat, grid_laplacian(shape, device="cpu"))
