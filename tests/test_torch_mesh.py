"""The unstructured slice of the PyTorch port against the JAX package: the
mesh Laplacian, the random generator, the SpMV routing, and CG on the
implicit mesh step I + τL through the ELL route.

Tolerances: the Laplacian and ``rand_csr`` equal array for array (their
values are exact in float64); CG takes the same iteration count and x
agrees to 1e-10 (absolute, max|x| is about 0.1): the two packages sum the
dot products in another order.
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.linalg import cg as jax_cg
from sprs_tpu.ops import prepare_spmv as jax_prepare_spmv
from sprs_tpu.utils.rand import rand_csr as jax_rand_csr
from sprs_tpu.utils.special import tri_mesh_graph_laplacian as jax_mesh_laplacian
from sprs_tpu_torch.errors import StructureError
from sprs_tpu_torch.formats.csmat import eye
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import cg
from sprs_tpu_torch.ops.prod import _route, prepare_spmv
from sprs_tpu_torch.utils import rand_csr, tri_mesh_graph_laplacian

TAU = 10.0


def permuted_mesh(side, seed=0):
    """A regular triangulation of a side×side vertex grid, two triangles
    per cell, labels permuted by ``default_rng(seed)``."""
    ii, jj = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    v = (ii * side + jj).ravel()
    tri = np.concatenate([np.stack([v, v + 1, v + side], 1),
                          np.stack([v + 1, v + side + 1, v + side], 1)])
    perm = np.random.default_rng(seed).permutation(side * side)
    return side * side, perm[tri]


def assert_same(port, jax_mat):
    assert port.shape == tuple(jax_mat.shape) and port.storage == jax_mat.storage
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(jax_mat, name)))


def port_of(m):
    return from_arrays(
        "csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage, device="cpu",
    )


@pytest.mark.parametrize("side,seed", [(5, 0), (9, 3)])
def test_mesh_laplacian_matches_jax(side, seed):
    n, tri = permuted_mesh(side, seed)
    # a repeated triangle, a degenerate one and an isolated vertex
    tri = np.concatenate([tri, tri[:1], [[0, 0, 1]]])
    got = tri_mesh_graph_laplacian(n + 1, tri, device="cpu")
    assert_same(got, jax_mesh_laplacian(n + 1, tri))
    assert got.dtype == torch.float64
    assert float(got.to_dense().sum()) == 0.0


def test_mesh_laplacian_range_error():
    with pytest.raises(StructureError):
        tri_mesh_graph_laplacian(3, [[0, 1, 3]], device="cpu")


@pytest.mark.parametrize(
    "shape,density,seed,storage",
    [((30, 20), 0.1, 0, "csr"), ((12, 40), 0.6, 1, "csr"), ((25, 25), 0.05, 2, "csc")],
)
def test_rand_csr_same_matrix_for_the_same_seed(shape, density, seed, storage):
    want = jax_rand_csr(shape, density, seed=seed, storage=storage)
    got = rand_csr(shape, density, seed=seed, storage=storage, device="cpu")
    assert_same(got, want)
    f32 = rand_csr(shape, density, seed=seed, dtype=torch.float32, device="cpu")
    assert f32.dtype == torch.float32


def test_rand_csr_custom_values():
    want = jax_rand_csr((10, 10), 0.3, seed=4, values=lambda rng, k: rng.random(k))
    got = rand_csr((10, 10), 0.3, seed=4, values=lambda rng, k: rng.random(k), device="cpu")
    assert_same(got, want)
    with pytest.raises(ValueError):
        rand_csr((3, 3), 1.5, device="cpu")


def route_cases():
    n, tri = permuted_mesh(16)
    return {
        "mesh": (jax_mesh_laplacian(n, tri), "ell", "EllMat"),
        "grid": (st.utils.grid_laplacian((12, 12), dtype=np.float64), "dia", "DiaMat"),
        # about 2 entries per row at random: ELL padding above 1.2
        "skewed": (jax_rand_csr((300, 300), 0.007, seed=5), "csr", "CsMat"),
    }


@pytest.mark.parametrize("name", ["mesh", "grid", "skewed"])
def test_route_matches_jax(name):
    m, route, jax_kind = route_cases()[name]
    t = port_of(m)
    _, j_prep = jax_prepare_spmv(m, use_pallas=False)
    assert type(j_prep).__name__ == jax_kind
    assert _route(t) == route
    fn, prepared = prepare_spmv(t)
    x = np.random.default_rng(6).standard_normal(m.cols)
    np.testing.assert_allclose(
        fn(prepared, torch.from_numpy(x)).numpy(), np.asarray(st.spmv(m, x)), rtol=1e-12, atol=1e-12
    )


def test_slice_cg_on_the_mesh_step_matches_jax():
    side = 16
    n, tri = permuted_mesh(side)
    b = np.zeros(n)
    b[n // 2] = 1.0
    jax_a = st.eye(n, np.float64) + jax_mesh_laplacian(n, tri) * TAU
    want = jax_cg(jax_a, b, tol=1e-8, max_iter=500)
    a = eye(n, torch.float64, device="cpu") + tri_mesh_graph_laplacian(n, tri, device="cpu") * TAU
    assert_same(a, jax_a)
    assert type(prepare_spmv(a)[1]).__name__ == "EllMat"
    got = cg(a, b, tol=1e-8, max_iter=500)
    assert got.converged and got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-10)
    true_res = np.linalg.norm(b - a.to_dense().numpy() @ got.x.numpy())
    assert true_res <= 1e-8 * np.linalg.norm(b)
