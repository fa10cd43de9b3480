"""The port's supernodal LDLᵀ (``sprs_tpu_torch.linalg.ldl_super``)
against the JAX package's ``sprs_tpu.linalg.ldl_super``.

Exactly equal: every integer of ``SuperPlan`` (and of its default round
schedule) on the 7×9, 12×12 and 13×9 grid Laplacians under every
fill-in reduction, and on a random SPD matrix (n = 40, density 0.1).
Within rtol 1e-10 in f64: ``numeric_supernodal`` against the JAX
function and the port's host numeric (arrowhead, tridiagonal, diagonal
and integer-valued cases, where supernodes are narrower than W), and
``solve_supernodal`` against the JAX function.  A zero pivot
NaN-poisons.  Inputs are made from seeds with numpy.
"""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.linalg import Ldl as JLdl
from sprs_tpu.linalg import ldl_batched as j_lb
from sprs_tpu.linalg import ldl_super as j_ls
from sprs_tpu_torch.formats.csmat import CsMat
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import Ldl
from sprs_tpu_torch.linalg import ldl_batched as t_lb
from sprs_tpu_torch.linalg import ldl_super as t_ls

RTOL = 1e-10
GRIDS = [(7, 9), (12, 12), (13, 9)]
FILLS = ["none", "rcm", "camd", "nd"]
PLAN_FIELDS = ("c0", "w", "rows", "off", "asm_src", "asm_dst", "t_type", "t_src", "t_dst",
               "t_rmap", "csc_gather", "below_ptr", "below_flat")
SCHED_FIELDS = ("upd_src", "upd_dst", "upd_tix", "upd_cnt", "fac_s", "fac_cnt", "agg_slots",
                "agg_cnt")


def port_of(m):
    return from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), storage=m.storage, device="cpu")


def random_spd(n=40, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return st.from_dense(a @ a.T + n * np.eye(n))


def dense_case(name):
    """The JAX package's structural corner cases (w < W throughout)."""
    if name == "tridiagonal":
        n = 37
        d = np.diag(2.0 + np.arange(n) * 0.1)
        idx = np.arange(n - 1)
        d[idx, idx + 1] = d[idx + 1, idx] = -1.0
    elif name == "arrowhead":
        n = 30
        d = np.eye(n) * 4.0
        d[-1, :] = d[:, -1] = 1.0
        d[-1, -1] = n
    else:  # diagonal: no below rows anywhere
        d = np.diag(np.arange(1.0, 9.0))
    return st.from_dense(d)


@lru_cache(maxsize=None)
def case(name, fill):
    """(JAX matrix, JAX symbolic, port matrix, port symbolic)."""
    if name == "random40":
        m = random_spd()
    elif name.startswith("grid"):
        r, c = name[4:].split("x")
        m = st.utils.dirichlet_laplacian((int(r), int(c)))
    else:
        m = dense_case(name)
    pm = port_of(m)
    return (m, JLdl().fill_in_reduction(fill).check_symmetry(False).symbolic(m), pm,
            Ldl().fill_in_reduction(fill).check_symmetry(False).symbolic(pm))


def assert_plans_equal(got, want, extra=()):
    for f in ("n", "S", "W", "MR", "P") + tuple(extra):
        assert getattr(got, f) == getattr(want, f), f
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


def assert_scheds_equal(got, want):
    assert (got.R, got.upd_mr, got.fac_mr) == (want.R, want.upd_mr, want.fac_mr)
    for f in SCHED_FIELDS:
        assert len(getattr(got, f)) == len(getattr(want, f)), f
        for g, w in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)


def assert_factor_close(lx, d, host_l, host_d, rtol=RTOL):
    host_l, host_d = np.asarray(host_l), np.asarray(host_d)
    scale = max(np.abs(host_l).max(), 1.0)
    lx = lx.numpy() if isinstance(lx, torch.Tensor) else np.asarray(lx)
    d = d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
    np.testing.assert_allclose(lx, host_l, rtol=rtol, atol=rtol * scale)
    np.testing.assert_allclose(d, host_d, rtol=rtol)


@pytest.mark.parametrize("name,fill", [(f"grid{r}x{c}", f) for r, c in GRIDS for f in FILLS]
                         + [("random40", "camd")])
def test_super_plan_equal(name, fill):
    _, jsym, _, tsym = case(name, fill)
    want, got = j_ls.build_super_plan(jsym), t_ls.build_super_plan(tsym)
    assert_plans_equal(got, want)
    assert_scheds_equal(t_lb.build_round_schedule(got), j_lb.build_round_schedule(want))


def test_plan_limits_raise():
    _, _, _, tsym = case("grid12x12", "nd")
    with pytest.raises(t_ls.SupernodalPlanError, match="panel storage"):
        t_ls.build_super_plan(tsym, panel_limit=16)
    with pytest.raises(t_ls.SupernodalPlanError, match="row-map"):
        t_ls.build_super_plan(tsym, map_limit=16)


@pytest.mark.parametrize("name,fill", [("grid12x12", "camd"), ("random40", "none")])
def test_numeric_supernodal_matches_jax(name, fill):
    m, jsym, pm, tsym = case(name, fill)
    data = np.array(m.to_csr().data, np.float64)
    jl, jd = j_ls.numeric_supernodal(jsym.super_plan(), data)
    lx, d = t_ls.numeric_supernodal(tsym.super_plan(), torch.from_numpy(data))
    assert_factor_close(lx, d, jl, jd)
    host = tsym.factor(pm, backend="host")
    assert_factor_close(lx, d, host.l_data, host.d)


@pytest.mark.parametrize("name,fill", [("tridiagonal", "none"), ("arrowhead", "none"),
                                       ("diagonal", "none"), ("grid12x12", "rcm"),
                                       ("grid13x9", "nd")])
def test_numeric_supernodal_matches_host(name, fill):
    _, _, pm, tsym = case(name, fill)
    lx, d = t_ls.numeric_supernodal(tsym.super_plan(), pm.to_csr().data)
    host = tsym.factor(pm, backend="host")
    assert_factor_close(lx, d, host.l_data, host.d)


@pytest.mark.parametrize("fill", ["camd", "rcm"])
def test_integer_valued_laplacian_has_no_nan(fill):
    """Integer data promotes to float32; the masked outer-product row
    keeps narrow panels of integer Laplacians free of NaN."""
    _, _, pm, tsym = case("grid12x12", fill)
    a = pm.to_csr()
    ints = CsMat(a.indptr, a.indices, a.data.round().to(torch.int32), a.shape, a.storage)
    num = tsym.factor(ints, backend="supernodal")
    assert num.l_data.dtype == torch.float32
    assert torch.isfinite(num.l_data).all() and torch.isfinite(num.d).all()
    host = tsym.factor(pm, backend="host")
    assert_factor_close(num.l_data.double(), num.d.double(), host.l_data, host.d, rtol=1e-5)


def test_zero_pivot_poisons():
    d = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 2.0]])
    pm = port_of(st.from_dense(d))
    num = Ldl().symbolic(pm).factor(pm, backend="supernodal")
    assert torch.isnan(num.d).any() and torch.isnan(num.l_data).any()


@pytest.mark.parametrize("k", [0, 3], ids=["vector", "block"])
def test_solve_supernodal_matches_jax(k):
    m, jsym, pm, tsym = case("grid12x12", "camd")
    host = tsym.factor(pm, backend="host")
    plan, jplan = tsym.super_plan(), jsym.super_plan()
    lx = host.l_data.numpy()
    rng = np.random.default_rng(11)
    b = rng.standard_normal(144) if k == 0 else rng.standard_normal((144, k))
    panels = t_ls.panels_from_csc(plan, host.l_data)
    got = t_ls.solve_supernodal(plan, panels, host.d, torch.from_numpy(b)).numpy()
    jpan = j_ls.panels_from_csc(jplan, lx)
    one = lambda c: j_ls.solve_supernodal(jplan, jpan, host.d.numpy(), c)  # noqa: E731
    want = np.asarray(one(b) if k == 0 else jax.vmap(one, in_axes=1, out_axes=1)(b))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    np.testing.assert_array_equal(panels.numpy(), np.asarray(jpan))


@pytest.mark.gpu
def test_supernodal_on_the_card():
    """The sequential numeric on a CUDA tensor agrees with the CPU run and
    repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pm, tsym = case("grid12x12", "nd")
    data = pm.to_csr().data
    plan = tsym.super_plan()
    cpu = t_ls.numeric_supernodal(plan, data)
    first = t_ls.numeric_supernodal(plan, data.cuda())
    again = t_ls.numeric_supernodal(plan, data.cuda())
    for c, f, a in zip(cpu, first, again):
        assert torch.equal(f, a)
        np.testing.assert_allclose(f.cpu().numpy(), c.numpy(), rtol=1e-12, atol=1e-12)
