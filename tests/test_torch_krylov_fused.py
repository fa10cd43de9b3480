"""Kernel K8 (BiCGSTAB's fused passes, ``ops/cuda/krylov.py``) of the
PyTorch port.

On the CPU the fused iteration (``linalg/bicgstab.py::_fused``) runs
each pass through a plain torch twin defined here (the ``twins``
fixture); it is held against the masked loop (``_plain``, what
``linalg.bicgstab`` runs on the CPU) through every branch of the loop:
the soft restart, the hard restart, a breakdown, convergence, a right
preconditioner and a given x0.  The twins take each sum of products in
float64 and round it once to the type, as the kernels do, and every
other operation as the masked loop takes it.  The CUDA kernels run only
on the card: the ``gpu``-marked tests, which import no JAX:
``python -m pytest --noconftest tests/test_torch_krylov_fused.py -q -m gpu``.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import pytest
import torch

from sprs_tpu_torch import linalg
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.ops import prod
from sprs_tpu_torch.ops.cuda import dia_spmv_kernel, krylov
from sprs_tpu_torch.utils import grid_laplacian

solver = importlib.import_module("sprs_tpu_torch.linalg.bicgstab")
SOURCE = Path(__file__).resolve().parents[1] / "sprs_tpu_torch" / "csrc" / "krylov.cu"


def _rhs(seed: int, n: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g, dtype=torch.float64) * 2.0 - 1.0).to(dtype).to(device)


def _heat(side: int, dtype, device="cpu"):
    fn, prepared = prod.prepare_spmv(grid_laplacian((side, side), dtype, device=device))
    return lambda v: fn(prepared, v)


def _sum(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ u·v as the kernels take it: in float64, rounded once to u's type."""
    return torch.dot(u.double(), v.double()).to(u.dtype)


# the passes of ops/cuda/krylov.py, one twin each, on the workspace's ``sc``
def rhat_dot_v(rhat, v, w) -> None:
    sc = w.sc
    rv = _sum(rhat, v)
    safe = rv.abs() > sc[krylov.EPS]
    sc[krylov.SAFE] = safe
    sc[krylov.ALPHA] = torch.where(safe, sc[krylov.RHO] / torch.where(safe, rv, 1.0), 0.0)


def s_update(r, v, s, w) -> None:
    s.copy_(r - w.sc[krylov.ALPHA] * v)


def t_sums(t, s, w) -> None:
    sc = w.sc
    tt = _sum(t, t)
    big = tt > sc[krylov.EPS]
    sc[krylov.OMEGA] = torch.where(big, _sum(t, s) / torch.where(big, tt, 1.0), 0.0)


def xr_update(x, phat, shat, s, t, r, rhat, w) -> None:
    sc = w.sc
    alpha, omega, rho = sc[krylov.ALPHA], sc[krylov.OMEGA], sc[krylov.RHO]
    x.copy_(x + alpha * phat + omega * shat)
    r.copy_(s - omega * t)
    rho_new, rr = _sum(rhat, r), _sum(r, r)
    nr, nh = rr.sqrt(), _sum(rhat, rhat).sqrt()
    soft = rho_new.abs() < sc[krylov.EPS] * torch.maximum(nr * nh, sc[krylov.TINY])
    rho_next = torch.where(soft, rr, rho_new)
    sc[krylov.BETA] = torch.where(
        sc[krylov.SAFE].bool() & ~soft,
        (rho_next / torch.where(rho.abs() > 0, rho, 1.0)) * (alpha / torch.where(omega.abs() > 0, omega, 1.0)),
        0.0,
    )
    sc[krylov.SOFT] = soft
    sc[krylov.RHO_NEXT] = rho_next
    sc[krylov.REC] = nr <= sc[krylov.THRESH]


def true_residual(b, ax, w) -> None:
    sc = w.sc
    d = b - ax
    tr2 = _sum(d, d)
    small = tr2.sqrt() <= sc[krylov.THRESH]
    rec = sc[krylov.REC].bool()
    lied = rec & ~small
    sc[krylov.DONE] = rec & small
    sc[krylov.LIED] = lied
    sc[krylov.RHO] = torch.where(lied, tr2, sc[krylov.RHO_NEXT])


def p_update(b, ax, r, rhat, p, v, w) -> None:
    sc = w.sc
    if bool(sc[krylov.LIED]):
        d = b - ax
        for u in (r, rhat, p):
            u.copy_(d)
    elif bool(sc[krylov.SOFT]):
        rhat.copy_(r)
        p.copy_(r)
    else:
        p.copy_(r + sc[krylov.BETA] * (p - sc[krylov.OMEGA] * v))


PASSES = {"rhat_dot_v": rhat_dot_v, "s_update": s_update, "t_sums": t_sums, "xr_update": xr_update,
          "true_residual": true_residual, "p_update": p_update}


def _install_twins(monkeypatch):
    for name, fn in PASSES.items():
        monkeypatch.setattr(krylov, name, fn)


@pytest.fixture
def twins(monkeypatch):
    """The fused loop's passes as their plain torch twins."""
    _install_twins(monkeypatch)


def _flags(monkeypatch):
    """Record, per iteration of a fused solve, whether the step was safe
    (α ≠ 0 by the guard), the soft restart fired and the recursive
    residual lied, as the passes left them in ``sc``."""
    seen = {"safe": [], "soft": [], "lied": []}
    xr, true = krylov.xr_update, krylov.true_residual

    def xr_update(*args):
        xr(*args)
        sc = args[-1].sc
        seen["safe"].append(bool(sc[krylov.SAFE]))
        seen["soft"].append(bool(sc[krylov.SOFT]))

    def true_residual(*args):
        true(*args)
        seen["lied"].append(bool(args[-1].sc[krylov.LIED]))

    monkeypatch.setattr(krylov, "xr_update", xr_update)
    monkeypatch.setattr(krylov, "true_residual", true_residual)
    return seen


class Lying:
    """The heat operator, except that every true-residual product (the
    third of each iteration) is off by a fixed vector of norm 0.05·‖b‖:
    once the recursive residual passes ``tol`` the true one cannot, so
    every such iteration is a hard restart.  The calls come in the same
    order in both loops, so both see the same products."""

    def __init__(self, side, dtype, device="cpu"):
        self.a = _heat(side, dtype, device)
        self.calls = 0
        self.off = None

    def __call__(self, v):
        y = self.a(v)
        self.calls += 1
        if self.calls > 1 and (self.calls - 1) % 3 == 0:
            y = y + self.off
        return y


def _rotations(dtype, device="cpu"):
    """A block-diagonal of 2 × 2 rotations [[0, −1], [1, 0]]: for b on the
    even coordinates, r̂·(A·r) = 0 exactly, the breakdown α = 0."""
    def matvec(v):
        y = torch.empty_like(v)
        y[0::2], y[1::2] = -v[1::2], v[0::2]
        return y
    b = torch.zeros(12, dtype=dtype, device=device)
    b[0::2] = torch.arange(1, 7, dtype=dtype, device=device)
    return matvec, b


def _case(name, dtype, device="cpu"):
    """(matvec, precond, b, x0, tol, max_iter, restart_eps) of one case."""
    side = 12
    b = _rhs(5, side * side, dtype, device)
    if name == "sets":  # the benchmark's set: tolerance 0, a fixed count
        return _heat(side, dtype, device), None, b, torch.zeros_like(b), 0.0, 10, 1e-30
    if name == "soft":  # |r̂·r| < 0.2·‖r̂‖‖r‖ fires the soft restart
        return _heat(side, dtype, device), None, b, torch.zeros_like(b), 0.0, 10, 0.2
    if name == "lied":
        op = Lying(side, dtype, device)
        u = _rhs(6, b.numel(), dtype, device)
        op.off = 0.05 * torch.linalg.vector_norm(b) * u / torch.linalg.vector_norm(u)
        return op, None, b, torch.zeros_like(b), 1e-2, 30, 1e-30
    if name == "breakdown":
        matvec, b = _rotations(dtype, device)
        return matvec, None, b, torch.zeros_like(b), 0.0, 4, 1e-30
    if name == "converged":  # float32 rounds near 1e-6·‖b‖, so its counts would part there
        tol = 1e-8 if dtype == torch.float64 else 1e-3
        return _heat(side, dtype, device), None, b, torch.zeros_like(b), tol, 200, 1e-30
    if name == "precond":  # Jacobi: 1/4 inside, 1 on the border rows
        d = grid_laplacian((side, side), dtype, device=device).diag()
        return _heat(side, dtype, device), (lambda v: v / d), b, torch.zeros_like(b), 0.0, 10, 1e-30
    if name == "x0":
        return _heat(side, dtype, device), None, b, _rhs(7, b.numel(), dtype, device), 0.0, 10, 1e-30
    raise ValueError(name)


CASES = ["sets", "soft", "lied", "breakdown", "converged", "precond", "x0"]
# what each case must have made happen in the fused run
FIRED = {"soft": ("soft", True), "lied": ("lied", True), "breakdown": ("safe", False)}
# x against the plain loop, relative to max|x|.  float64: the twins' sums
# (float64 dots, ‖r‖ as the root of r·r) round as the loop's vdot and
# vector_norm do here, measured equal to 0 to 2e-16 in 10 iterations;
# float32: the twins sum in float64 where the loop sums in float32, a
# relative 1e-7 a sum that 10 iterations grow to 2e-6 at most here
TOL = {torch.float64: 1e-13, torch.float32: 1e-4}


def _plain0(matvec, b, tol, max_iter, precond=None):
    """The masked loop from x = 0, as ``linalg.bicgstab`` runs it."""
    x = torch.zeros_like(b)
    return solver._plain(matvec, precond, b, x, b - matvec(x), tol, max_iter, 1e-30)


def _run(loop, case, dtype, device="cpu"):
    matvec, precond, b, x0, tol, max_iter, eps = _case(case, dtype, device)
    keep = x0.clone()
    r0 = b - matvec(x0)
    keep_r0 = r0.clone()
    res = loop(matvec, precond, b, x0, r0, tol, max_iter, eps)
    assert torch.equal(x0, keep), "x0 was written"
    assert torch.equal(r0, keep_r0), "r0 was written"
    return res


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_fused_iteration_equals_the_plain_loop(case, dtype, twins, monkeypatch):
    plain = _run(solver._plain, case, dtype)
    seen = _flags(monkeypatch)
    fused = _run(solver._fused, case, dtype)
    assert fused.iterations == plain.iterations and fused.converged == plain.converged
    if case in FIRED:
        flag, value = FIRED[case]
        assert value in seen[flag], f"{case}: {flag} never {value}"
    if case == "converged":
        assert fused.converged and fused.iterations < 200
    scale = float(plain.x.abs().max())
    assert scale > 0 or case == "breakdown"
    err = float((fused.x - plain.x).abs().max()) / max(scale, 1e-300)
    if case == "converged" and dtype == torch.float32:
        # both stop once ‖r‖ ≤ 1e-3·‖b‖, so each x is within about
        # cond(A)·1e-3 of the solution and the last steps follow rounding:
        # measured 6.7e-4 apart; each true residual passes
        assert err <= 1e-2, err
        b_norm = float(torch.linalg.vector_norm(_case(case, dtype)[2]))
        assert max(fused.residual_norm, plain.residual_norm) <= 1e-3 * b_norm
    else:
        assert err <= TOL[dtype], err
        assert fused.residual_norm == pytest.approx(plain.residual_norm, rel=TOL[dtype] * 100)


def test_breakdown_leaves_x_at_x0(twins):
    """r̂·v = 0 exactly: α = ω = 0 every iteration, so x stays 0."""
    res = _run(solver._fused, "breakdown", torch.float64)
    assert res.iterations == 4 and not res.converged and not bool(res.x.any())


def test_fused_loop_counts_its_iterations(twins):
    krylov.COUNTS.zero()
    res = _run(solver._fused, "sets", torch.float64)
    assert krylov.COUNTS.fused_iterations == res.iterations == 10
    assert krylov.COUNTS.plain_iterations == 0 and krylov.COUNTS.launches == 0  # twins only


def test_cpu_solves_take_the_plain_loop():
    """``linalg.bicgstab`` on CPU tensors runs the masked loop, unchanged."""
    krylov.COUNTS.zero()
    matvec, _, b, _, _, _, _ = _case("sets", torch.float64)
    res = linalg.bicgstab(matvec, b, tol=0.0, max_iter=7)
    want = _plain0(matvec, b, 0.0, 7)
    assert torch.equal(res.x, want.x) and res.residual_norm == want.residual_norm
    assert krylov.COUNTS.plain_iterations == 14 and krylov.COUNTS.fused_iterations == 0


def _b(kind):
    b = torch.rand(8, dtype=torch.float64)
    return {
        "f64": b,
        "f32": b.float(),
        "complex128": b.to(torch.complex128),
        "complex64": b.to(torch.complex64),
        "bf16": b.bfloat16(),
        "f16": b.half(),
        "strided": torch.rand(16, dtype=torch.float64)[::2],
        "2d": b.reshape(2, 4),
        "grad": b.clone().requires_grad_(),
    }[kind]


@pytest.mark.parametrize("kind", ["f64", "f32", "complex128", "complex64", "bf16", "f16", "strided",
                                  "2d", "grad"])
def test_the_rule(kind):
    """K8 takes real float32 and float64 contiguous vectors that need no
    gradient, on a CUDA device; every CPU tensor takes the plain loop."""
    b = _b(kind)
    assert not krylov.takes(b)
    err = krylov._refusal(b)
    assert (err is None) == (kind in ("f64", "f32"))


@pytest.mark.parametrize("what", ["x0", "residual", "values", "precond"])
def test_the_rule_follows_gradients(what):
    """Under grad mode any tensor of the solve that needs a gradient
    refuses K8; under ``no_grad`` none does, and the tensors are not
    read."""
    b = _b("f64")
    other = torch.rand(8, dtype=torch.float64, requires_grad=True)
    assert isinstance(krylov._refusal(b, [b.detach(), other]), ValueError), what
    assert krylov._refusal(b, [b.detach()]) is None

    def unread():
        raise AssertionError("read under no_grad")
        yield

    with torch.no_grad():
        assert krylov._refusal(b, [other]) is None and krylov._refusal(b, unread()) is None


def _grad_solve(what, dtype=torch.float64, device="cpu"):
    """A 6² heat solve of 5 iterations through ``linalg.bicgstab`` in
    which a gradient can reach ``what`` (None: nothing): returns the
    solve's arguments and the tensor that needs the gradient."""
    m = grid_laplacian((6, 6), dtype, device=device)
    b = _rhs(21, 36, dtype, device)
    scale = torch.tensor(1.5, dtype=dtype, device=device, requires_grad=what in ("matvec", "precond"))
    x0 = (_rhs(22, 36, dtype, device) * 0.1).requires_grad_(what == "x0")
    if what == "values":
        m = type(m)(m.indptr, m.indices, m.data.clone().requires_grad_(), m.shape, m.storage)
    mat = m
    if what == "matvec":
        fn, prepared = prod.prepare_spmv(m)
        mat = lambda v: scale * fn(prepared, v)  # noqa: E731
    precond = (lambda v: v / scale) if what == "precond" else None
    leaf = {"values": m.data, "x0": x0, "matvec": scale, "precond": scale}.get(what)
    return (mat, b, x0, precond), leaf


@pytest.mark.parametrize("what", [None, "values", "x0", "matvec", "precond", "no_grad"])
def test_bicgstab_sends_a_solve_that_needs_a_gradient_to_the_plain_loop(what, twins, monkeypatch):
    """With the device test set aside, ``linalg.bicgstab`` takes the fused
    loop unless a gradient can reach x through the matrix's values, x0,
    a matvec or a preconditioner that closes over a parameter; those
    solves run the plain loop, whose gradient autograd follows."""
    monkeypatch.setattr(krylov, "takes", lambda b, grads=(): krylov._refusal(b, grads) is None)
    (mat, b, x0, precond), leaf = _grad_solve("values" if what == "no_grad" else what)
    krylov.COUNTS.zero()
    if what == "no_grad":
        with torch.no_grad():
            res = linalg.bicgstab(mat, b, x0, tol=0.0, max_iter=5, precond=precond)
    else:
        res = linalg.bicgstab(mat, b, x0, tol=0.0, max_iter=5, precond=precond)
    fused = what in (None, "no_grad")
    assert (krylov.COUNTS.fused_iterations, krylov.COUNTS.plain_iterations) == ((5, 0) if fused else (0, 5))
    assert res.x.requires_grad == (not fused)
    if not fused:
        got, = torch.autograd.grad(res.x.sum(), leaf)
        a_op, _ = solver.as_matvec(mat)
        want = solver._plain(a_op, precond, b, x0, b - a_op(x0), 0.0, 5, 1e-30)
        expect, = torch.autograd.grad(want.x.sum(), leaf)
        assert float(got.abs().max()) > 0 and torch.equal(got, expect)


@pytest.mark.parametrize("bad, error", [
    (lambda v: v[:-1], ShapeError),
    (lambda v: v.float(), TypeError),
    (lambda v: v.tolist(), TypeError),
], ids=["shape", "dtype", "not_a_tensor"])
def test_fused_loop_refuses_a_wrong_matvec_result(bad, error, twins):
    b = _rhs(1, 16)
    with pytest.raises(error):
        solver._fused(bad, None, b, torch.zeros_like(b), b.clone(), 0.0, 3, 1e-30)
    with pytest.raises(error):
        solver._fused(lambda v: v, bad, b, torch.zeros_like(b), b.clone(), 0.0, 3, 1e-30)
    with pytest.raises(error):
        solver._fused(lambda v: v, None, b, torch.zeros_like(b), bad(b), 0.0, 3, 1e-30)


def test_strided_matvec_result_is_made_contiguous():
    b = _rhs(2, 16)
    y = krylov.vector(torch.rand(32, dtype=torch.float64)[::2], b, "matvec")
    assert y.is_contiguous() and y.shape == b.shape


def test_grid_is_fixed_by_n():
    per = krylov.THREADS * krylov.UNROLL
    assert [krylov.grid(n) for n in (0, 1, per, per + 1, 4096 ** 2)] == [1, 1, 1, 2, krylov.MAX_GRID]


def test_source_constants_match():
    """The wrapper's launch constants and slots are the kernel's."""
    text = SOURCE.read_text()
    for name, value in (("kThreads", krylov.THREADS), ("kUnroll", krylov.UNROLL),
                        ("kMaxGrid", krylov.MAX_GRID)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    enum = re.search(r"enum Slot \{([^}]*)\}", text).group(1)
    assert len([s for s in enum.split(",") if s.strip()]) == len(krylov.SLOTS)
    for suffix in krylov.SHORT.values():
        for name in ("rv", "s", "tt", "xr", "true", "p"):
            assert f"sprs_k8_{name}_##SUFFIX" in text and f"SPRS_K8_ENTRIES({suffix}," in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _heat_pair(side, dtype, iters, device, seed=11):
    a = _heat(side, dtype, device)
    b = _rhs(seed, side * side, dtype, device)
    fused = linalg.bicgstab(a, b, tol=0.0, max_iter=iters)
    plain = _plain0(a, b, 0.0, iters)
    return fused, plain


# x after 10 iterations against the plain loop on the card, relative to
# max|x|.  The two take their sums in other orders (and K8 float32 sums in
# float64), a relative 1e-16 (f64) or 1e-7 (f32) a sum, which BiCGSTAB on
# this operator can grow about 10^4.5 times in 10 iterations (PERF.md §2);
# measured 7e-16 to 2.5e-15 (f64) and 2.9e-7 to 1.7e-6 (f32) on an H100
CARD_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("side", [64, 1024, 4096])
def test_k8_against_the_plain_loop_on_the_card(cuda, side, dtype):
    krylov.COUNTS.zero()
    fused, plain = _heat_pair(side, dtype, 10, cuda)
    assert krylov.COUNTS.launches == 6 * 10 and krylov.COUNTS.plain_iterations == 10
    assert krylov.COUNTS.fused_iterations == 10
    assert fused.iterations == plain.iterations == 10
    err = float((fused.x - plain.x).abs().max() / plain.x.abs().max())
    print(f"K8 {side}^2 {dtype}: x against the plain loop {err!r}")
    assert err <= CARD_TOL[dtype]


# the true residual of K8 over the plain loop's after RESID_ITERS
# iterations of the 256² solve, both from x = 0: 0.85 to 1.07 over five b
# on an H100 (0.18 to 2.6 by 400 iterations, where rounding has parted
# the two), while a wrong update parts them by far more (β halved reads
# 25 times the plain loop's residual at 200 iterations, on the CPU
# through the twins)
RESID_ITERS = 200
RESID_RATIO = 4.0


@pytest.mark.gpu
def test_k8_heat_solve_converges_as_the_plain_loop(cuda):
    """To 1e-8 at 256²: both converge with a true residual under the
    tolerance, K8's count within 15 % of the plain loop's on the card,
    and after RESID_ITERS iterations of each K8's true residual within
    RESID_RATIO times the plain loop's either way.  Some 500 iterations
    in, the count follows rounding: for this b the plain loop took 561
    iterations on the CPU and 567 on the card, K8 547 (an H100)."""
    a = _heat(256, torch.float64, cuda)
    b = _rhs(12, 256 * 256, torch.float64, cuda)
    fused = linalg.bicgstab(a, b, tol=1e-8, max_iter=5000)
    plain = _plain0(a, b, 1e-8, 5000)
    b_norm = float(torch.linalg.vector_norm(b))
    ratio = (linalg.bicgstab(a, b, tol=0.0, max_iter=RESID_ITERS).residual_norm
             / _plain0(a, b, 0.0, RESID_ITERS).residual_norm)
    print(f"K8 256^2 to 1e-8: {fused.iterations} iterations, plain {plain.iterations}; "
          f"residual ratio at {RESID_ITERS} iterations {ratio!r}")
    assert fused.converged and plain.converged
    assert fused.residual_norm <= 1e-8 * b_norm
    assert abs(fused.iterations - plain.iterations) <= 0.15 * plain.iterations
    assert 1.0 / RESID_RATIO <= ratio <= RESID_RATIO


@pytest.mark.gpu
def test_k8_is_deterministic(cuda):
    a = _heat(1024, torch.float64, cuda)
    b = _rhs(13, 1024 * 1024, torch.float64, cuda)
    first = linalg.bicgstab(a, b, tol=0.0, max_iter=50)
    second = linalg.bicgstab(a, b, tol=0.0, max_iter=50)
    assert torch.equal(first.x.view(torch.int64), second.x.view(torch.int64))
    assert first.residual_norm == second.residual_norm


@pytest.mark.gpu
def test_k8_counts(cuda):
    """Six K8 launches and three K1 products an iteration (two more a
    solve), no plain iteration; a refused b runs the plain loop and
    launches no K8 pass."""
    a = _heat(256, torch.float64, cuda)
    b = _rhs(14, 256 * 256, torch.float64, cuda)
    krylov.COUNTS.zero()
    dia_spmv_kernel.launches = 0
    res = linalg.bicgstab(a, b, tol=0.0, max_iter=20)
    assert (krylov.COUNTS.launches, krylov.COUNTS.launches_f64, krylov.COUNTS.launches_f32) == (120, 120, 0)
    assert (krylov.COUNTS.fused_iterations, krylov.COUNTS.plain_iterations) == (20, 0)
    assert dia_spmv_kernel.launches == 3 * res.iterations + 2
    krylov.COUNTS.zero()
    strided = torch.stack([b, b], 1)[:, 0]
    assert not strided.is_contiguous()
    res = linalg.bicgstab(lambda v: a(v.contiguous()), strided, tol=0.0, max_iter=5)
    assert krylov.COUNTS.launches == 0 and krylov.COUNTS.plain_iterations == 5
    assert res.iterations == 5


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["values", "x0"])
def test_k8_gives_way_to_a_gradient_on_the_card(cuda, what):
    """A card solve through which a gradient reaches the matrix's values
    or x0 runs the plain loop: its gradient is that of ``_plain``."""
    (mat, b, x0, _), leaf = _grad_solve(what, device=cuda)
    krylov.COUNTS.zero()
    res = linalg.bicgstab(mat, b, x0, tol=0.0, max_iter=5)
    assert krylov.COUNTS.launches == 0 and krylov.COUNTS.plain_iterations == 5
    got, = torch.autograd.grad(res.x.sum(), leaf)
    a_op, _ = solver.as_matvec(mat)
    want = solver._plain(a_op, None, b, x0, b - a_op(x0), 0.0, 5, 1e-30)
    expect, = torch.autograd.grad(want.x.sum(), leaf)
    assert float(got.abs().max()) > 0
    torch.testing.assert_close(got, expect, rtol=1e-12, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["soft", "lied", "breakdown", "precond", "x0"])
def test_k8_branches_on_the_card(cuda, case, monkeypatch):
    """Each branch forced on the card: the same flags as the twins on the
    CPU, and x as the plain loop's on the card."""
    plain = _run(solver._plain, case, torch.float64, cuda)
    seen = _flags(monkeypatch)
    fused = _run(solver._fused, case, torch.float64, cuda)
    if case in FIRED:
        flag, value = FIRED[case]
        assert value in seen[flag]
    monkeypatch.undo()
    _install_twins(monkeypatch)
    seen_cpu = _flags(monkeypatch)
    _run(solver._fused, case, torch.float64)
    assert seen == seen_cpu
    assert fused.iterations == plain.iterations and fused.converged == plain.converged
    scale = max(float(plain.x.abs().max()), 1e-300)
    assert float((fused.x - plain.x).abs().max()) / scale <= 1e-12
