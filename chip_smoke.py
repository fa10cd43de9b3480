#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sprs_tpu_torch``) on one GPU.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the port, compiled from ``csrc/``;
3. gate: each kernel against its plain torch version on the card, on
   small, odd and full-size operands in float32 and float64;
4. timing: K1 at the 4096×4096-grid Laplacian SpMV (n = 16,777,216,
   float32) and at the 1024×1024 float64 solve size, with CUDA events,
   beside its bytes bound, its plain version and one library call;
5. main path: BiCGSTAB on the 1024×1024 grid Laplacian and CG on the
   1024×1024 Dirichlet Laplacian, float64, tol 1e-8, through
   ``prepare_spmv`` and K1; checks convergence, the true residual and
   that K1 was launched exactly 3·iters+2 and iters+2 times;
6. the kernels line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from sprs_tpu_torch.formats.util import round_up
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import bicgstab, cg
from sprs_tpu_torch.ops import prepare_spmv
from sprs_tpu_torch.ops.cuda import build
from sprs_tpu_torch.ops.cuda.dia_spmv import (
    dia_spmv_kernel,
    dia_spmv_plain,
    dia_tile,
)
from sprs_tpu_torch.utils import dirichlet_laplacian, grid_laplacian

# H100 SXM data sheet: HBM3 rate and the non-tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# kernel vs plain: the same sum order over the diagonals; only FMA
# contraction differs.  Relative to max |y|.
GATE_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-12}
SOLVE_TOL = 1e-8
SOLVE_SIDE = 1024
SPMV_SIDE = 4096
# Rehearsed on the CPU: iterations grow linearly with the side (side
# 256: BiCGSTAB 464, CG 454), so 1024 needs about 1,900.
MAX_ITER = 10000
PROFILE_ITERS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}, count {count}, torch {torch.__version__}, cuda {torch.version.cuda}")
    log(smi)
    return name, count


def phase_build():
    t0 = time.perf_counter()
    infos = build.build()
    log(f"build: {len(infos)} source(s) in {time.perf_counter() - t0:.3f} s")
    for info in infos.values():
        log(f"  {info.name}: {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            log(f"    {line}")


def banded_operand(rows, cols, offsets, dtype, seed):
    """Random DIA operand with zeros where a diagonal leaves the matrix."""
    rng = np.random.default_rng(seed)
    rows_pad = round_up(rows, 8)
    data = rng.standard_normal((len(offsets), rows_pad))
    i = np.arange(rows_pad)
    for d, off in enumerate(offsets):
        data[d, (i >= rows) | (i + off < 0) | (i + off >= cols)] = 0.0
    dia = from_arrays(
        "dia", (rows, cols), (data.astype(dtype),), offsets=offsets, device="cuda"
    )
    x = torch.from_numpy(rng.standard_normal(cols).astype(dtype)).cuda()
    return dia_tile(dia), x


def laplacian_operand(mat, seed):
    dia = dia_tile(mat.to_dia())
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(dia.cols)).to("cuda", dia.dtype)
    return dia, x


def gate_one(name, dia, x):
    y = dia_spmv_kernel(dia, x)
    ref = dia_spmv_plain(dia, x)
    torch.cuda.synchronize()
    if y.shape != (dia.rows,) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)}")
    err = float((y - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-300)
    limit = GATE_LIMIT[dia.dtype]
    log(f"gate {name}: max_abs_err {err!r} rel {rel!r} (limit {limit})")
    if not rel <= limit:
        raise AssertionError(f"gate {name}: rel {rel} > {limit}")
    return err


def gate_grad():
    """The autograd backward on the card against torch's own autograd of
    the plain version on the CPU."""
    dia, x = laplacian_operand(grid_laplacian((64, 64), device="cuda"), 7)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(dia.rows)).cuda()
    data = dia.data.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    y = dia_spmv_kernel(type(dia)(data, dia.offsets, dia.shape), xx)
    dd, dx = torch.autograd.grad(y, (data, xx), g)
    data_c = dia.data.cpu().requires_grad_(True)
    x_c = x.cpu().requires_grad_(True)
    y_c = dia_spmv_plain(type(dia)(data_c, dia.offsets, dia.shape), x_c)
    dd_c, dx_c = torch.autograd.grad(y_c, (data_c, x_c), g.cpu())
    err = max(float((dd.cpu() - dd_c).abs().max()), float((dx.cpu() - dx_c).abs().max()))
    log(f"gate grad (64x64 grid, float64): max_abs_err {err!r}")
    if not err <= 1e-12:
        raise AssertionError(f"gate grad: {err}")


def phase_gate(lap_spmv):
    errs = []
    for dtype in (np.float32, np.float64):
        tdt = torch.float32 if dtype == np.float32 else torch.float64
        lap = grid_laplacian((64, 64), tdt, device="cuda")
        errs.append(gate_one(f"64x64 grid {tdt}", *laplacian_operand(lap, 1)))
        offs = (-70, -3, -1, 0, 2, 65)
        errs.append(
            gate_one(f"band 5000x4803 {offs} {tdt}", *banded_operand(5000, 4803, offs, dtype, 2))
        )
    for mat, label in (
        (grid_laplacian((SOLVE_SIDE,) * 2, device="cuda"), "grid"),
        (dirichlet_laplacian((SOLVE_SIDE,) * 2, device="cuda"), "dirichlet"),
    ):
        errs.append(gate_one(f"{SOLVE_SIDE}^2 {label} float64", *laplacian_operand(mat, 3)))
    spmv_err = gate_one(f"{SPMV_SIDE}^2 grid float32", *lap_spmv)
    gate_grad()
    return max(errs + [spmv_err]), spmv_err


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(dia, x):
    """Least time for y = A @ x: every input byte read once and y
    written once at the HBM rate, or 2·k·rows flops at the peak."""
    nbytes = (dia.data.numel() + x.numel() + dia.rows) * dia.data.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * dia.n_diags * dia.rows / PEAK_FLOPS[dia.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_timing(label, mat, dia, x, reps):
    ms = time_ms(lambda: dia_spmv_kernel(dia, x), reps)
    plain_ms = time_ms(lambda: dia_spmv_plain(dia, x), max(reps // 5, 3))
    nnz = mat.nnz
    csr = torch.sparse_csr_tensor(
        mat.indptr, mat.indices[:nnz], mat.data[:nnz], size=mat.shape
    )
    lib_err = float((torch.mv(csr, x) - dia_spmv_plain(dia, x)).abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x), reps)
    b_ms, b_by, nbytes = bound_ms(dia, x)
    row = {
        "shape": label,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bytes": nbytes,
        "roofline_share": b_ms / ms,
        "library_max_abs_err": lib_err,
    }
    log(f"timing {json.dumps(row)}")
    return row


def check_solution(name, res, a_dia, b, launches, expected):
    true_res = float(torch.linalg.vector_norm(b - dia_spmv_plain(a_dia, res.x)))
    b_norm = float(torch.linalg.vector_norm(b))
    log(
        f"{name}: iterations {res.iterations} converged {res.converged} "
        f"true residual {true_res!r} (limit {SOLVE_TOL * b_norm!r}) "
        f"K1 launches {launches} (expected {expected})"
    )
    if not res.converged:
        raise AssertionError(f"{name} did not converge in {res.iterations} iterations")
    if not bool(torch.isfinite(res.x).all()) or res.x.shape != b.shape:
        raise AssertionError(f"{name}: bad solution")
    if not true_res <= SOLVE_TOL * b_norm:
        raise AssertionError(f"{name}: true residual {true_res} > {SOLVE_TOL * b_norm}")
    if launches != expected:
        raise AssertionError(f"{name}: K1 launched {launches} times, expected {expected}")


def check_small_against_dense():
    """BiCGSTAB and CG on 32x32 grids on the card against numpy's dense
    solve.  Both solves stop at a residual of 1e-8·‖b‖ and the operators'
    condition numbers are about 440, so x may differ from the dense
    solution by about 4.4e-6 of max|x|: the limit is 1e-5.  (Iteration
    counts may differ from a CPU run by a few: BiCGSTAB amplifies the
    rounding of reductions taken in another order.)"""
    side = 32
    n = side * side
    rhs = np.zeros(n)
    rhs[(side // 2) * side + side // 2] = 1.0
    for name, solver, make in (
        ("bicgstab", bicgstab, grid_laplacian),
        ("cg", cg, dirichlet_laplacian),
    ):
        a = make((side, side), device="cuda")
        res = solver(a, rhs, tol=SOLVE_TOL, max_iter=MAX_ITER)
        ref = np.linalg.solve(a.to_dense().cpu().numpy(), rhs)
        rel = float(np.abs(res.x.cpu().numpy() - ref).max() / np.abs(ref).max())
        log(f"small {name} 32x32 vs dense solve: iterations {res.iterations} rel err {rel!r}")
        if not (res.converged and rel <= 1e-5):
            raise AssertionError(f"small {name}: rel err {rel}, converged {res.converged}")


def phase_main_path():
    side = SOLVE_SIDE
    n = side * side
    lap = grid_laplacian((side, side), device="cuda")
    rhs = torch.zeros(n, dtype=torch.float64, device="cuda")
    rhs[(side // 2) * side + side // 2] = 1.0
    spd = dirichlet_laplacian((side, side), device="cuda")
    spd_dia = spd.to_dia()
    b = dia_spmv_plain(spd_dia, torch.ones(n, dtype=torch.float64, device="cuda"))
    lap_dia = lap.to_dia()
    for label, mat in (("grid", lap), ("dirichlet", spd)):
        t0 = time.perf_counter()
        prepare_spmv(mat)
        log(f"prepare_spmv {side}^2 {label}: {time.perf_counter() - t0!r} s")
    torch.cuda.synchronize()

    dia_spmv_kernel.launches = 0
    t0 = time.perf_counter()
    res_b = bicgstab(lap, rhs, tol=SOLVE_TOL, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = dia_spmv_kernel.launches
    t0 = time.perf_counter()
    res_c = cg(spd, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches = dia_spmv_kernel.launches

    log(f"bicgstab {side}^2 float64: wall {wall_b!r} s (prepare_spmv included)")
    check_solution("bicgstab", res_b, lap_dia, rhs, launches_b, 3 * res_b.iterations + 2)
    log(f"cg {side}^2 float64: wall {wall_c!r} s (prepare_spmv included)")
    check_solution("cg", res_c, spd_dia, b, launches - launches_b, res_c.iterations + 2)
    return launches, lap, rhs


def phase_profile(lap, rhs):
    """Device busy share of BiCGSTAB iterations at the main path's size:
    torch.profiler over PROFILE_ITERS iterations (set-up excluded), the
    same iterations timed untraced beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn, prepared = prepare_spmv(lap)

    def run():
        t0 = time.perf_counter()
        bicgstab(lambda v: fn(prepared, v), rhs, tol=SOLVE_TOL, max_iter=PROFILE_ITERS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run()
    untraced_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels if "dia_spmv" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    row = {
        "iterations": PROFILE_ITERS,
        "untraced_ms": untraced_ms,
        "traced_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "k1_ms": k1_ms,
        "top_kernels": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top],
    }
    log(f"profile bicgstab {SOLVE_SIDE}^2 float64 {json.dumps(row)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    name, count = phase_device()
    phase_build()

    t0 = time.perf_counter()
    lap_spmv = grid_laplacian((SPMV_SIDE,) * 2, torch.float32, device="cuda")
    spmv_operand = laplacian_operand(lap_spmv, 0)
    log(f"setup: {SPMV_SIDE}^2 grid Laplacian and DIA in {time.perf_counter() - t0:.3f} s")
    max_err, spmv_err = phase_gate(spmv_operand)

    big = phase_timing(f"{SPMV_SIDE}^2 grid float32", lap_spmv, *spmv_operand, reps=50)
    lap_solve = grid_laplacian((SOLVE_SIDE,) * 2, device="cuda")
    phase_timing(
        f"{SOLVE_SIDE}^2 grid float64", lap_solve, *laplacian_operand(lap_solve, 4), reps=200
    )
    del lap_spmv, spmv_operand
    lap_small = grid_laplacian((64, 64), device="cuda")
    phase_timing("64^2 grid float64", lap_small, *laplacian_operand(lap_small, 5), reps=2000)

    check_small_against_dense()
    launches, lap, rhs = phase_main_path()
    if launches == 0:
        raise AssertionError("the main path launched no K1 kernel")
    phase_profile(lap, rhs)

    kernels = [
        {
            "name": "dia_spmv",
            "route": "cuda",
            "source": "sprs_tpu_torch/csrc/dia_spmv.cu",
            "replaces": "sprs_tpu/ops/pallas/dia_spmv.py:232",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": big["ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"],
            "library_ms": big["library_ms"],
            "ok": True,
            "shape": big["shape"],
            "shape_max_abs_err": spmv_err,
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
