"""The port's multifrontal-lite LDLᵀ (``sprs_tpu_torch.linalg.ldl_mf``)
against the JAX package's ``sprs_tpu.linalg.ldl_mf``.

Exactly equal: every integer of ``MfPlan`` (the aggregate window tables
per bucket included) and of its default round schedule on the 7×9,
12×12 and 13×9 grid Laplacians under every fill-in reduction, on a
random SPD matrix (n = 40, density 0.1), and across the front budgets
(``max_cols`` 8, 24, 10,000 at 9×13, camd).  Within rtol 1e-10 in f64:
``numeric_multifrontal`` against the JAX function and the port's host
numeric, with fronts small enough that the aggregates carry most of the
updates.  Inputs are made from seeds with numpy.
"""

import numpy as np
import pytest
import torch

from sprs_tpu.linalg import ldl_batched as j_lb
from sprs_tpu.linalg import ldl_mf as j_lm
from sprs_tpu_torch.linalg import ldl_batched as t_lb
from sprs_tpu_torch.linalg import ldl_mf as t_lm
from tests.test_torch_ldl_super import (
    FILLS,
    GRIDS,
    assert_factor_close,
    assert_plans_equal,
    assert_scheds_equal,
    case,
)

MF_TABLES = ("mem_start", "memd_start", "tgt_start", "tgt_lim", "colmap")


def assert_mf_plans_equal(got, want):
    assert_plans_equal(got, want, extra=("F", "RF", "AW"))
    for f in MF_TABLES:
        assert len(getattr(got, f)) == len(getattr(want, f)), f
        for g, w in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)


@pytest.mark.parametrize("name,fill", [(f"grid{r}x{c}", f) for r, c in GRIDS for f in FILLS]
                         + [("random40", "camd")])
def test_mf_plan_equal(name, fill):
    _, jsym, _, tsym = case(name, fill)
    want, got = j_lm.build_mf_plan(jsym), t_lm.build_mf_plan(tsym)
    assert_mf_plans_equal(got, want)
    assert_scheds_equal(t_lb.build_round_schedule(got), j_lb.build_round_schedule(want))


@pytest.mark.parametrize("max_cols", [8, 24, 10_000])
def test_front_budget_plans_and_numeric(max_cols):
    _, jsym, pm, tsym = case("grid9x13", "camd")
    kw = dict(max_front_cols=max_cols, max_front_rows=10_000)
    want, got = j_lm.build_mf_plan(jsym, **kw), t_lm.build_mf_plan(tsym, **kw)
    assert_mf_plans_equal(got, want)
    assert (got.F == 1) == (max_cols >= 10_000)
    lx, d = t_lm.numeric_multifrontal(got, pm.to_csr().data)
    host = tsym.factor(pm, backend="host")
    assert_factor_close(lx, d, host.l_data, host.d)


def test_row_budget_cut():
    """A tiny rows budget still gives an exact factor."""
    _, jsym, pm, tsym = case("grid10x10", "rcm")
    kw = dict(max_front_cols=8, max_front_rows=4)
    plan = t_lm.build_mf_plan(tsym, **kw)
    assert_mf_plans_equal(plan, j_lm.build_mf_plan(jsym, **kw))
    assert plan.F > 1
    lx, d = t_lm.numeric_multifrontal(plan, pm.to_csr().data)
    host = tsym.factor(pm, backend="host")
    assert_factor_close(lx, d, host.l_data, host.d)


@pytest.mark.parametrize("name,fill,max_cols", [("grid12x12", "camd", 8), ("grid13x9", "nd", 8)])
def test_numeric_multifrontal_matches_jax(name, fill, max_cols):
    m, jsym, pm, tsym = case(name, fill)
    data = np.array(m.to_csr().data, np.float64)
    jplan = j_lm.build_mf_plan(jsym, max_front_cols=max_cols)
    plan = t_lm.build_mf_plan(tsym, max_front_cols=max_cols)
    assert plan.F > 1 and len(plan.mem_start) > 0
    jl, jd = j_lm.numeric_multifrontal(jplan, data)
    lx, d = t_lm.numeric_multifrontal(plan, torch.from_numpy(data))
    assert_factor_close(lx, d, jl, jd)
    host = tsym.factor(pm, backend="host")
    assert_factor_close(lx, d, host.l_data, host.d)


def test_factor_backend_mf_refactorizes():
    """``backend="mf"`` through the symbolic, then ``update`` with
    rescaled values on the same plan."""
    _, _, pm, tsym = case("grid9x9", "camd")
    num = tsym.factor(pm, backend="mf")
    host = tsym.factor(pm, backend="host")
    assert_factor_close(num.l_data, num.d, host.l_data, host.d)
    scaled = pm.with_data(pm.data * 3.0)
    again = num.update(scaled, backend="mf")
    host3 = tsym.factor(scaled, backend="host")
    assert_factor_close(again.l_data, again.d, host3.l_data, host3.d)


@pytest.mark.gpu
def test_multifrontal_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pm, tsym = case("grid12x12", "camd")
    plan = t_lm.build_mf_plan(tsym, max_front_cols=8)
    data = pm.to_csr().data
    cpu = t_lm.numeric_multifrontal(plan, data)
    first = t_lm.numeric_multifrontal(plan, data.cuda())
    again = t_lm.numeric_multifrontal(plan, data.cuda())
    for c, f, a in zip(cpu, first, again):
        assert torch.equal(f, a)
        np.testing.assert_allclose(f.cpu().numpy(), c.numpy(), rtol=1e-12, atol=1e-12)
