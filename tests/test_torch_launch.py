"""The port's one launch module (``ops/cuda/launch.py``) and the rule by
which every product wrapper runs its plain twin, its autograd
``Function`` or its direct launch.

On the CPU the rule is driven with CPU tensors and with ``meta`` tensors
standing in for a card, each with and without a gradient; counting
stand-ins replace the three ways, so no kernel runs.  The ``gpu`` test
holds K5's direct launch against its autograd path on the card.  This
file imports no JAX: run its card test with ``python -m pytest
--noconftest tests/test_torch_launch.py -q -m gpu``.
"""

import numpy as np
import pytest
import torch

from sprs_tpu_torch.formats.bsr import bsr_from_dense
from sprs_tpu_torch.formats.csmat import from_dense
from sprs_tpu_torch.formats.dia import DiaMat, dia_from_csmat
from sprs_tpu_torch.formats.ell import EllMat, ell_from_csmat
from sprs_tpu_torch.ops.cuda import bsr_spmm as k34
from sprs_tpu_torch.ops.cuda import csr_spmv as k7
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda import dia_spmv as k1
from sprs_tpu_torch.ops.cuda import ell_spmv as k5
from sprs_tpu_torch.ops.cuda import launch


def dense(rows, cols, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, cols))
    a[rng.random((rows, cols)) > 0.3] = 0.0
    return a


def operands(kernel):
    """(operand, x, module, its plain twin's name, its Function, the
    product) for ``kernel``, on the CPU."""
    mat = from_dense(dense(24, 16, 1), device="cpu")
    if kernel in ("K1", "K2"):
        band = from_dense(np.triu(np.tril(dense(24, 16, 2), 2), -1), device="cpu")
        dia = dia_from_csmat(band)
        if kernel == "K1":
            return (dia, torch.ones(16, dtype=torch.float64), k1, "dia_spmv_plain", k1._DiaSpmv,
                    k1.dia_spmv_kernel)
        return (dia, torch.ones((16, 3), dtype=torch.float64), k2, "dia_spmm_plain", k2._DiaSpmm,
                k2.dia_spmm_kernel)
    if kernel == "K5":
        return (ell_from_csmat(mat), torch.ones(16, dtype=torch.float64), k5, "ell_spmv_plain",
                k5._EllSpmv, k5.ell_spmv_kernel)
    if kernel == "K7":
        return (mat, torch.ones(16, dtype=torch.float64), k7, "csr_spmv_plain", k7._CsrSpmv,
                k7.csr_spmv_kernel)
    bsr = bsr_from_dense(dense(32, 16, 3), 8, device="cpu")
    if kernel == "K3":
        return (bsr, torch.ones((16, 3), dtype=torch.float64), k34, "_plain", k34._BsrSpmm,
                k34.bsr_spmm_kernel)
    return (bsr, torch.ones((16, 3), dtype=torch.float64), k34, "_plain", k34._BsrSpmm,
            lambda m, x: k34.bsr_spmm_grouped_kernel(m, x, group=1))


def moved(op, device, grad):
    """``op`` with every tensor on ``device``, its values needing a
    gradient where ``grad``."""
    def to(t):
        t = t.to(device)
        return t.requires_grad_(True) if grad and t.is_floating_point() else t

    if isinstance(op, DiaMat):
        return DiaMat(to(op.data), op.offsets, op.shape)
    if isinstance(op, EllMat):
        return EllMat(to(op.indices), to(op.data), op.shape)
    fields = {f: getattr(op, f) for f in op.__dataclass_fields__}
    return type(op)(**{f: to(v) if isinstance(v, torch.Tensor) else v for f, v in fields.items()})


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K7"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("grad", ["none", "x", "values", "values under no_grad"])
def test_every_wrapper_takes_its_way_by_the_one_rule(kernel, device, grad, monkeypatch):
    """Plain twin on CPU tensors, direct launch on the card (``meta``
    here), the autograd Function wherever grad mode is on and an operand
    needs a gradient; each product takes exactly one of the three."""
    op, x, module, plain_name, function, product = operands(kernel)
    op = moved(op, device, grad in ("values", "values under no_grad"))
    x = x.to(device).requires_grad_(grad == "x")
    taken = []

    def stand_in(way):
        def run(*args):
            taken.append((way, args[-1] if way == "direct" and kernel in ("K3", "K4") else None))
            return torch.zeros(1)
        return run

    monkeypatch.setattr(module, plain_name, stand_in("plain"))
    monkeypatch.setattr(module, "_launch", stand_in("direct"))
    monkeypatch.setattr(function, "apply", stand_in("function"))
    if grad == "values under no_grad":
        with torch.no_grad():
            product(op, x)
    else:
        product(op, x)
    if grad in ("x", "values"):
        want = "function"
    else:
        want = "plain" if device == "cpu" else "direct"
    assert [way for way, _ in taken] == [want]
    if want == "direct" and kernel in ("K3", "K4"):
        assert taken[0][1] is (k34.bsr_spmm_kernel if kernel == "K3" else k34.bsr_spmm_grouped_kernel)


@pytest.mark.parametrize("grad", [False, True])
def test_run_answers_from_the_inputs_alone(grad):
    """``run``: the Function where grad mode is on and a tensor needs a
    gradient, else the plain twin when every tensor is on the CPU and the
    direct launch when one is not; it calls that way alone."""
    cpu = torch.ones(2, requires_grad=grad)
    meta = torch.ones(2, device="meta")
    ways = (lambda: "plain", lambda: "function", lambda: "direct")
    assert launch.run((cpu, cpu), *ways) == ("function" if grad else "plain")
    assert launch.run((meta, cpu), *ways) == ("function" if grad else "direct")
    assert launch.run((meta,), *ways) == "direct"
    with torch.no_grad():
        assert launch.run((cpu, cpu), *ways) == "plain"
        assert launch.run((meta, cpu), *ways) == "direct"


def test_counters_and_the_error_check():
    """``count`` adds one to ``launches`` and to each tag's counter;
    ``zero`` sets the named tags and every counter already kept to 0;
    ``check`` raises with the kernel's wording on a nonzero code."""
    def owner():
        pass

    launch.zero(owner, ("f64", "tma"))
    launch.count(owner, "f64", "tma")
    launch.count(owner, "f64")
    assert (owner.launches, owner.launches_f64, owner.launches_tma) == (2, 2, 1)
    launch.zero(owner)
    assert (owner.launches, owner.launches_f64, owner.launches_tma) == (0, 0, 0)
    launch.check(0, "ell_spmv kernel")
    with pytest.raises(RuntimeError, match=r"^dia_spmm kernel \(tma\) launch failed: CUDA error 700$"):
        launch.check(700, "dia_spmm kernel (tma)")


def test_one_card_names_every_device():
    cpu, meta = torch.ones(1), torch.ones(1, device="meta")
    with pytest.raises(ValueError, match=r"^ell_spmv kernel needs indices, data and x on one CUDA "
                                         r"device, got cpu, meta and cpu$"):
        launch.one_card("ell_spmv", "indices, data and x", cpu, meta, cpu)
    with pytest.raises(ValueError, match=r"got meta and meta$"):
        launch.one_card("dia_spmm", "data and X", meta, meta)


@pytest.mark.gpu
def test_k5_without_gradient_makes_no_function_call_on_card(monkeypatch):
    """On the card a K5 product that needs no gradient launches directly
    (no ``_EllSpmv.apply``), and its output equals, bit for bit, the
    autograd path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ell = ell_from_csmat(from_dense(dense(4000, 3000, 4), device="cuda"))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(3000)).cuda()
    via_function = k5.ell_spmv_kernel(EllMat(ell.indices, ell.data.clone().requires_grad_(True),
                                             ell.shape), x)
    assert via_function.grad_fn is not None
    applied = []
    real = k5._EllSpmv.apply
    monkeypatch.setattr(k5._EllSpmv, "apply", lambda *a: applied.append(a) or real(*a))
    launches = k5.ell_spmv_kernel.launches
    direct = k5.ell_spmv_kernel(ell, x)
    with torch.no_grad():
        no_grad = k5.ell_spmv_kernel(EllMat(ell.indices, ell.data.clone().requires_grad_(True),
                                                 ell.shape), x)
    assert applied == [] and k5.ell_spmv_kernel.launches == launches + 2
    assert direct.grad_fn is None and no_grad.grad_fn is None
    assert torch.equal(direct, via_function.detach()) and torch.equal(no_grad, direct)
