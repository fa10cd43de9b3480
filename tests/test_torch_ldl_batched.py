"""The port's level-batched LDLᵀ (``sprs_tpu_torch.linalg.ldl_batched``)
against the JAX package's ``sprs_tpu.linalg.ldl_batched``.

Exactly equal: the round schedules across the round widths (bu, bf, ba)
∈ {(1,1,1), (3,2,2), (64,64,8)} and ``max_classes`` ∈ {1, 2, 4, 8}.
Within rtol 1e-10 in f64: ``blocked_ldl_top`` (its loop stopped at the
widest live column included), ``numeric_batched`` for both plan kinds
against the JAX function and the port's host numeric, ``solve_batched``
against the JAX function, ``solve(method="super")`` by both branches of
the ``SOLVE_BATCHED_MIN_S`` gate on a vector and an (n, k) block, N
value sets at once against N single factors, and the deeper 64² nd
schedule (port only).  Inputs are made from seeds with numpy.
"""

import jax
import numpy as np
import pytest
import torch

from sprs_tpu.linalg import ldl_batched as j_lb
from sprs_tpu.linalg import ldl_mf as j_lm
from sprs_tpu_torch.linalg import Ldl
from sprs_tpu_torch.linalg import ldl_batched as t_lb
from sprs_tpu_torch.linalg import ldl_mf as t_lm
from sprs_tpu_torch.linalg import ldl_super as t_ls
from sprs_tpu_torch.utils import dirichlet_laplacian
from tests.test_torch_ldl_super import (
    RTOL,
    assert_factor_close,
    assert_scheds_equal,
    case,
)


def plans(name, fill, kind, **kw):
    """(JAX plan, port plan, port matrix, port symbolic)."""
    _, jsym, pm, tsym = case(name, fill)
    if kind == "super":
        return jsym.super_plan(**kw), tsym.super_plan(**kw), pm, tsym
    return j_lm.build_mf_plan(jsym, **kw), t_lm.build_mf_plan(tsym, **kw), pm, tsym


def host_factor(pm, tsym):
    return tsym.factor(pm, backend="host")


def test_blocked_ldl_top_matches_jax():
    rng = np.random.default_rng(4)
    B, W = 5, 24
    a = rng.standard_normal((B, W, W))
    top = a @ a.transpose(0, 2, 1) + W * np.eye(W)
    ws = np.array([24, 17, 9, 1, 20])
    live = np.arange(W)[None, :] < ws[:, None]
    top = np.where(live[:, None, :] & live[:, :, None], top, 0) + np.eye(W) * ~live[:, None, :]
    jm, jd = j_lb.blocked_ldl_top(jax.numpy.asarray(top), jax.numpy.asarray(live))
    for n_live in (None, int(ws.max())):
        m, d = t_lb.blocked_ldl_top(torch.from_numpy(top), torch.from_numpy(live), n_live=n_live)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-12)
    m, _ = t_lb.blocked_ldl_top(torch.from_numpy(top), torch.from_numpy(live), n_live=int(ws.max()))
    full, _ = t_lb.blocked_ldl_top(torch.from_numpy(top), torch.from_numpy(live))
    assert torch.equal(m, full)


@pytest.mark.parametrize("bu,bf,ba", [(1, 1, 1), (3, 2, 2), (64, 64, 8)])
def test_round_width_sweep(bu, bf, ba):
    jplan, plan, pm, tsym = plans("grid9x13", "camd", "mf", max_front_cols=24)
    sched = t_lb.build_round_schedule(plan, bu=bu, bf=bf, ba=ba)
    assert_scheds_equal(sched, j_lb.build_round_schedule(jplan, bu=bu, bf=bf, ba=ba))
    lx, d = t_lb.numeric_batched(plan, sched, pm.to_csr().data)
    host = host_factor(pm, tsym)
    assert_factor_close(lx, d, host.l_data, host.d)


@pytest.mark.parametrize("max_classes", [1, 2, 4, 8])
def test_class_count_sweep(max_classes):
    jplan, plan, pm, tsym = plans("grid11x13", "camd", "super")
    sched = t_lb.build_round_schedule(plan, max_classes=max_classes)
    assert_scheds_equal(sched, j_lb.build_round_schedule(jplan, max_classes=max_classes))
    assert len(sched.upd_mr) <= max_classes
    if max_classes == 1:
        assert sched.upd_mr == (plan.MR,)
    lx, d = t_lb.numeric_batched(plan, sched, pm.to_csr().data)
    host = host_factor(pm, tsym)
    assert_factor_close(lx, d, host.l_data, host.d)


@pytest.mark.parametrize("kind", ["super", "mf"])
def test_numeric_batched_matches_jax(kind):
    kw = {"max_front_cols": 16} if kind == "mf" else {}
    jplan, plan, pm, tsym = plans("grid12x12", "camd", kind, **kw)
    data = pm.to_csr().data
    jsched, sched = j_lb.build_round_schedule(jplan), t_lb.build_round_schedule(plan)
    assert sched.R < plan.n_tasks
    jl, jd = j_lb.numeric_batched(jplan, jsched, data.numpy())
    lx, d = t_lb.numeric_batched(plan, sched, data)
    assert_factor_close(lx, d, jl, jd)
    host = host_factor(pm, tsym)
    assert_factor_close(lx, d, host.l_data, host.d)


def test_solve_batched_matches_jax():
    jplan, plan, pm, tsym = plans("grid13x9", "camd", "mf", max_front_cols=24)
    host = host_factor(pm, tsym)
    sched = t_lb.build_round_schedule(plan)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(tsym.n)
    panels = t_ls.panels_from_csc(plan, host.l_data)
    got = t_lb.solve_batched(plan, sched, panels, host.d, torch.from_numpy(b)).numpy()
    from sprs_tpu.linalg import ldl_super as j_ls

    want = np.asarray(j_lb.solve_batched(jplan, j_lb.build_round_schedule(jplan),
                                         j_ls.panels_from_csc(jplan, host.l_data.numpy()),
                                         host.d.numpy(), b))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    seq = t_ls.solve_supernodal(plan, panels, host.d, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, seq, rtol=RTOL, atol=RTOL * np.abs(seq).max())


@pytest.mark.parametrize("k", [0, 4], ids=["vector", "block"])
def test_super_solve_gate_routes_on_plan_size(k, monkeypatch):
    """``solve(method="super")`` takes the round-batched sweeps only from
    ``SOLVE_BATCHED_MIN_S`` supernodes on (8192 on CPU tensors); both
    branches agree with the dense oracle and each other."""
    _, _, pm, tsym = case("grid13x9", "camd")
    num = tsym.factor(pm, backend="mf-batched")
    plan = tsym.panel_plan()
    assert tsym.__dict__["_round_scheds"].get(id(plan)) is not None
    assert num.solve_method("auto") == "super"
    assert t_lb.solve_batched_min_s("cpu") == t_lb.SOLVE_BATCHED_MIN_S == 8192
    assert plan.S < t_lb.SOLVE_BATCHED_MIN_S
    rng = np.random.default_rng(7)
    b = rng.standard_normal(tsym.n) if k == 0 else rng.standard_normal((tsym.n, k))
    dense = pm.to_dense().numpy()
    x_ref = np.linalg.solve(dense, b)
    calls = []
    monkeypatch.setattr(t_lb, "solve_batched",
                        lambda *a, _f=t_lb.solve_batched: calls.append(1) or _f(*a))
    x_seq = num.solve(torch.from_numpy(b)).numpy()
    assert not calls
    monkeypatch.setattr(t_lb, "SOLVE_BATCHED_MIN_S", 1)
    x_bat = num.solve(torch.from_numpy(b)).numpy()
    assert calls
    for x in (x_seq, x_bat):
        np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-10 * np.abs(x_ref).max())
    np.testing.assert_allclose(x_bat, x_seq, rtol=1e-12, atol=1e-12 * np.abs(x_seq).max())
    if k:
        for j in range(k):
            col = num.solve(torch.from_numpy(b[:, j].copy())).numpy()
            np.testing.assert_allclose(x_bat[:, j], col, rtol=1e-13, atol=1e-14)


def test_members_match_single_factors():
    """N value sets as one leading axis: each member equals its own
    batched factor and solve."""
    _, _, pm, tsym = case("grid9x13", "nd")
    plan = tsym.mf_plan(max_front_cols=16)
    sched = tsym.round_schedule(plan)
    a = pm.to_csr()
    scales = (1.0, 2.5, 4.0)
    lx, d = t_lb.numeric_batched(plan, sched, torch.stack([a.data * s for s in scales]))
    panels = t_ls.panels_from_csc(plan, lx)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal((3, tsym.n)))
    xb = t_lb.solve_batched(plan, sched, panels, d, b)
    xs = t_ls.solve_supernodal(plan, panels, d, b)
    for i, s in enumerate(scales):
        li, di = t_lb.numeric_batched(plan, sched, a.data * s)
        np.testing.assert_allclose(lx[i].numpy(), li.numpy(), rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(d[i].numpy(), di.numpy(), rtol=1e-13)
        one = t_ls.solve_supernodal(plan, panels[i], d[i], b[i])
        np.testing.assert_allclose(xs[i].numpy(), one.numpy(), rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(xb[i].numpy(), one.numpy(), rtol=1e-10, atol=1e-12)


def test_64_grid_nd_mf_batched():
    """A deeper schedule: 64² nd (S 133, R 6) against the host numeric."""
    a = dirichlet_laplacian((64, 64), device="cpu")
    sym = Ldl().fill_in_reduction("nd").symbolic(a)
    num = sym.factor(a, backend="mf-batched")
    host = sym.factor(a, backend="host")
    assert_factor_close(num.l_data, num.d, host.l_data, host.d)
    b = torch.linspace(1.0, 2.0, sym.n, dtype=torch.float64)
    x = num.solve(b)
    r = a.to_scipy() @ x.numpy() - b.numpy()
    assert np.abs(r).max() <= 1e-10 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["super", "mf"])
def test_batched_on_the_card(kind):
    """The batched phases on a CUDA tensor: a repeat factor is bit-equal
    to the first (ordered index_put_ sums), both agree with the CPU run,
    and the round-batched solve agrees with the sequential one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pm, tsym = case("grid12x12", "nd")
    plan = tsym.super_plan() if kind == "super" else tsym.mf_plan(max_front_cols=16)
    sched = tsym.round_schedule(plan)
    data = pm.to_csr().data
    cpu = t_lb.numeric_batched(plan, sched, data)
    first = t_lb.numeric_batched(plan, sched, data.cuda())
    again = t_lb.numeric_batched(plan, sched, data.cuda())
    for c, f, g in zip(cpu, first, again):
        assert torch.equal(f, g)
        np.testing.assert_allclose(f.cpu().numpy(), c.numpy(), rtol=1e-12, atol=1e-12)
    panels = t_ls.panels_from_csc(plan, first[0])
    b = torch.linspace(-1.0, 1.0, tsym.n, dtype=torch.float64, device="cuda")
    xb = t_lb.solve_batched(plan, sched, panels, first[1], b)
    xs = t_ls.solve_supernodal(plan, panels, first[1], b)
    np.testing.assert_allclose(xb.cpu().numpy(), xs.cpu().numpy(), rtol=1e-10, atol=1e-12)
