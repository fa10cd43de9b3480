"""Randomized parity fuzzing of the PyTorch port vs scipy/numpy oracles,
the counterpart of tests/test_fuzz.py: the same random shapes,
densities, storages and tolerances through the port's op surface on the
CPU, the distributed case on the port's own mesh of four ``"cpu"``
slots.
"""

import numpy as np
import pytest
import torch

import sprs_tpu_torch as st

DEV = "cpu"


def h(a):
    """A result on the host as numpy."""
    return a.numpy() if isinstance(a, torch.Tensor) else h(a)

CASES = list(range(12))


def rand_case(seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 40))
    c = int(rng.integers(1, 40))
    density = float(rng.uniform(0.02, 0.6))
    d = rng.standard_normal((r, c))
    d[rng.random((r, c)) > density] = 0.0
    storage = "csr" if rng.random() < 0.5 else "csc"
    return rng, d, storage


@pytest.mark.parametrize("seed", CASES)
def test_roundtrip_and_transpose(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, storage=storage, device=DEV)
    m.check_structure()
    np.testing.assert_allclose(h(m.to_dense()), d)
    np.testing.assert_allclose(h(m.T.to_dense()), d.T)
    np.testing.assert_allclose(
        h(m.to_other_storage().to_dense()), d
    )


@pytest.mark.parametrize("seed", CASES)
def test_spmv_spmm(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, storage=storage, device=DEV)
    x = rng.standard_normal(d.shape[1])
    np.testing.assert_allclose(
        h(st.spmv(m, torch.from_numpy(x))), d @ x, rtol=1e-10, atol=1e-12
    )
    k = int(rng.integers(1, 6))
    X = rng.standard_normal((d.shape[1], k))
    np.testing.assert_allclose(
        h(st.spmm(m, torch.from_numpy(X))), d @ X, rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("seed", CASES)
def test_spgemm_vs_scipy(seed):
    rng, d, storage = rand_case(seed)
    e = rng.standard_normal((d.shape[1], int(rng.integers(1, 30))))
    e[rng.random(e.shape) > 0.3] = 0.0
    a = st.from_dense(d, storage=storage, device=DEV)
    b = st.from_dense(e, device=DEV)
    c = st.spgemm(a, b)
    c.check_structure()
    ref = a.to_scipy() @ b.to_scipy()
    np.testing.assert_allclose(
        h(c.to_dense()), ref.toarray(), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("seed", CASES)
def test_spgemm_dense_vs_scipy(seed):
    # the dense route must agree with scipy up to the
    # documented caveat (exact-cancellation entries dropped) — with
    # random continuous values, cancellation is measure-zero
    rng, d, storage = rand_case(seed)
    e = rng.standard_normal((d.shape[1], int(rng.integers(1, 30))))
    e[rng.random(e.shape) > 0.3] = 0.0
    a = st.from_dense(d, storage=storage, device=DEV)
    b = st.from_dense(e, device=DEV)
    c = st.spgemm_dense(a, b)
    c.to_csr().check_structure()
    ref = a.to_scipy() @ b.to_scipy()
    np.testing.assert_allclose(
        h(c.to_dense()), ref.toarray(), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("seed", CASES)
def test_add_sub_mul(seed):
    rng, d, storage = rand_case(seed)
    e = rng.standard_normal(d.shape)
    e[rng.random(d.shape) > 0.3] = 0.0
    a = st.from_dense(d, storage=storage, device=DEV)
    b = st.from_dense(e, device=DEV)
    np.testing.assert_allclose(
        h((a + b).to_dense()), d + e, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        h((a - b).to_dense()), d - e, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        h((a * b).to_dense()), d * e, rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("seed", CASES[:6])
def test_formats_roundtrip(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, device=DEV)
    np.testing.assert_allclose(h(m.to_ell().to_dense()), d)
    np.testing.assert_allclose(
        h(m.to_bsr(8).to_dense()), d, rtol=1e-6
    )
    dia = m.to_dia()
    np.testing.assert_allclose(h(dia.to_dense()), d, rtol=1e-6)


@pytest.mark.parametrize("seed", CASES[:6])
def test_triplet_duplicates(seed):
    rng = np.random.default_rng(seed + 100)
    r, c = int(rng.integers(2, 20)), int(rng.integers(2, 20))
    n = int(rng.integers(1, 60))
    rows = rng.integers(0, r, n)
    cols = rng.integers(0, c, n)
    vals = rng.standard_normal(n)
    m = st.TriMat.from_triplets((r, c), rows, cols, vals).to_csr(device=DEV)
    m.check_structure()
    ref = np.zeros((r, c))
    np.add.at(ref, (rows, cols), vals)
    np.testing.assert_allclose(
        h(m.to_dense()), ref, rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("seed", CASES[:6])
def test_permutations(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, storage=storage, device=DEV)
    p = st.Permutation.from_array(
        np.random.default_rng(seed).permutation(d.shape[0]).astype(np.int32), device=DEV
    )
    perm_rows = h(st.permute_rows(m, p).to_dense())
    np.testing.assert_allclose(perm_rows, d[h(p.perm)], rtol=1e-10)


@pytest.mark.parametrize("seed", CASES[:8])
def test_reductions_and_elementwise_methods(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, storage=storage, device=DEV)
    np.testing.assert_allclose(float(m.sum()), d.sum(), rtol=1e-10)
    np.testing.assert_allclose(
        h(m.sum(axis=1)), d.sum(1), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        h(m.sum(axis=0)), d.sum(0), rtol=1e-10, atol=1e-12
    )
    d2 = rng.standard_normal(d.shape) * (rng.random(d.shape) < 0.4)
    b = st.from_dense(d2, storage=storage, device=DEV)
    np.testing.assert_allclose(
        h(m.multiply(b).to_dense()), d * d2, rtol=1e-10
    )
    np.testing.assert_allclose(
        h(m.maximum(b).to_dense()),
        np.maximum(d, d2),
        rtol=1e-10,
    )


@pytest.mark.parametrize("seed", CASES[:6])
def test_row_col_vs_dense(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, storage=storage, device=DEV)
    i = int(rng.integers(0, d.shape[0]))
    j = int(rng.integers(0, d.shape[1]))
    np.testing.assert_allclose(
        h(m.row(i).to_dense()), d[i], rtol=1e-10
    )
    np.testing.assert_allclose(
        h(m.col(j).to_dense()), d[:, j], rtol=1e-10
    )


@pytest.mark.parametrize("seed", CASES[:6])
def test_bsr_conversion_vs_dense(seed):
    rng, d, storage = rand_case(seed)
    m = st.from_dense(d, storage=storage, device=DEV)
    for bs in (4, 8):
        b = m.to_bsr(bs)
        np.testing.assert_allclose(
            h(b.to_dense()), d, rtol=1e-10
        )


@pytest.mark.parametrize("seed", CASES[:8])
def test_spgemm_batched_sort_vs_flat(seed):
    """Batched segment sort (random targets) bit-matches scipy."""
    from importlib import import_module

    sg = import_module("sprs_tpu_torch.ops.spgemm")
    rng = np.random.default_rng(100 + seed)
    r = int(rng.integers(5, 120))
    k = int(rng.integers(5, 120))
    c = int(rng.integers(5, 120))
    da = rng.standard_normal((r, k))
    da[rng.random((r, k)) > 0.2] = 0.0
    db = rng.standard_normal((k, c))
    db[rng.random((k, c)) > 0.2] = 0.0
    a = st.from_dense(da, device=DEV)
    b = st.from_dense(db, device=DEV)
    target = int(rng.integers(1, 200))
    old = sg.SORT_BATCH_MIN
    sg.SORT_BATCH_MIN = 1
    try:
        batches = sg.spgemm_sort_batches(a, b, target=target)
        out = sg.spgemm(a, b, sort_batches=batches)
    finally:
        sg.SORT_BATCH_MIN = old
    np.testing.assert_allclose(
        h(out.to_dense()), da @ db, rtol=1e-5, atol=1e-8
    )


@pytest.mark.parametrize("seed", CASES[:4])
def test_dist_spgemm_bgather_fuzz(seed):
    """bgather schedule vs dense oracle on random sparsity."""
    from sprs_tpu_torch.parallel import (
        Mesh,
        dist_spgemm_bgather,
        plan_b_gather,
        shard_csr_rows,
    )

    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(8, 60))
    m = int(rng.integers(8, 60))
    da = rng.standard_normal((n, m))
    da[rng.random((n, m)) > 0.15] = 0.0
    db = rng.standard_normal((m, n))
    db[rng.random((m, n)) > 0.15] = 0.0
    A = shard_csr_rows(st.from_dense(da, device=DEV), 4)
    B = shard_csr_rows(st.from_dense(db, device=DEV), 4)
    mesh = Mesh([DEV] * 4, ("shards",))
    out = dist_spgemm_bgather(
        A, B, mesh, plan=plan_b_gather(A, B)
    ).to_csmat()
    np.testing.assert_allclose(
        h(out.to_dense()), da @ db, rtol=1e-5, atol=1e-6
    )
