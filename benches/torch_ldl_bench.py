"""LDLᵀ refactorization benchmark: the panel numerics against the row
scan, the counterpart of ``benches/ldl_bench.py`` for the PyTorch/CUDA
port.

On the Dirichlet Laplacian of a grid (256² by default) it builds the
symbolic factor (``--fill``: rcm, camd, nd or none), the supernodal plan
and its level-batched round schedule, and the multifrontal plan, then
times on the card, as chains ``data = f(data)`` whose steps depend on the
previous factor (``utils/profile.py::chain_time_best``):

* the sequential supernodal numeric (``ldl_super.numeric_supernodal``;
  left out by ``--skip-seq``), the round-batched one on the supernodal
  plan and on the multifrontal plan (``ldl_batched.numeric_batched``);
* the solves of the batched factor: the panel solve
  (``ldl_super.solve_supernodal``), the level-scheduled and the flat
  solves (``LdlSymbolic.level_plans`` / ``flat_plans``), the inner
  sweeps only; the level solve is left out where n·(widest row) > 2²⁴;
* scipy's ``splu`` factor and solve on the host (float64), the external
  yardstick;
* the row-scan numeric (``ldl._numeric_device``) on ``--scan-grid``, with
  the speed-up per useful flop of the panel numerics over it.

Every factor is gated: the normwise backward error
‖Ax − b‖∞ / (‖A‖∞‖x‖∞ + ‖b‖∞) of a solve with it, b = linspace(1, 2, n),
must stay under 1e-5 in float32 (1e-13 in float64), or the bench raises.

Run from the repository root on a machine with one GPU:
``python3 benches/torch_ldl_bench.py [--grid 256] [--scan-grid N] [--iters 5]
[--scan-iters 2] [--dtype f32|f64] [--fill rcm] [--rel-zeros 0.65]
[--json results.json] [--skip-seq]``; ``--device cpu`` runs it on the
CPU.  Prints progress lines, then the record as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sprs_tpu_torch.linalg import Ldl  # noqa: E402
from sprs_tpu_torch.linalg.ldl import LdlNumeric, _numeric_device  # noqa: E402
from sprs_tpu_torch.linalg.ldl_batched import build_round_schedule, numeric_batched  # noqa: E402
from sprs_tpu_torch.linalg.ldl_mf import build_mf_plan  # noqa: E402
from sprs_tpu_torch.linalg.ldl_super import (  # noqa: E402
    build_super_plan,
    numeric_supernodal,
    panels_from_csc,
    solve_supernodal,
)
from sprs_tpu_torch.utils.profile import bench_device, card, chain_time_best  # noqa: E402
from sprs_tpu_torch.utils.special import dirichlet_laplacian  # noqa: E402

DTYPES = {"f32": torch.float32, "f64": torch.float64}
BACKWARD_ERROR_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-13}


def health_reference(device):
    """Seconds per step of a trivial elementwise chain over 1M floats."""
    x = torch.from_numpy(np.random.default_rng(0).random(1 << 20, np.float32)).to(device)
    return chain_time_best(lambda x: x * 1.01 + 1.0, x, iters=20, rounds=2)


def _scipy_baseline(a, n, iters=3):
    """Host f64 scipy splu factor + solve wall-clock on the same matrix."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    indptr = a.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    A = sp.csc_matrix(
        (
            a.data[:nnz].cpu().numpy().astype(np.float64),
            a.indices[:nnz].cpu().numpy().astype(np.int64),
            indptr,
        ),
        shape=(n, n),
    )
    b = np.linspace(1.0, 2.0, n)
    best_f = float("inf")
    lu = None
    for _ in range(2):
        t0 = time.perf_counter()
        lu = spla.splu(A)
        best_f = min(best_f, time.perf_counter() - t0)
    best_s = float("inf")
    for _ in range(max(iters, 3)):
        t0 = time.perf_counter()
        _ = lu.solve(b)
        best_s = min(best_s, time.perf_counter() - t0)
    return {
        "scipy_splu_factor_s": best_f,
        "scipy_splu_solve_s": best_s,
        "scipy_splu_lnz": int(lu.L.nnz + lu.U.nnz),
    }


def prep(grid, fill="rcm", device="cuda"):
    """(matrix, symbolic factor, CSR matrix, symbolic seconds)."""
    mat = dirichlet_laplacian((grid, grid), device=device)
    t0 = time.perf_counter()
    sym = Ldl().fill_in_reduction(fill).check_symmetry(False).symbolic(mat)
    t_sym = time.perf_counter() - t0
    a = mat.to_csr()
    return mat, sym, a, t_sym


def useful_flops(sym):
    """Simplicial factorization flops: sum over columns of c*(c+2)."""
    c = np.diff(np.asarray(sym.l_indptr)) - 1  # below-diag counts
    return float(np.sum(c * (c + 2.0)))


def flat_solve(sym, l_data, d, v):
    """x with L·D·Lᵀ x = v by the flat sweeps (the permuted system)."""
    lo, up = sym.flat_plans(l_data.device)
    return up.solve(l_data, lo.solve(l_data, v) / d)


def backward_error(a, sym, solve, dtype) -> float:
    """‖Ax − b‖∞ / (‖A‖∞‖x‖∞ + ‖b‖∞) in float64 on the host, x from
    ``solve`` (the permuted system's solve, in ``dtype``) for
    b = linspace(1, 2, n)."""
    n = sym.n
    b = np.linspace(1.0, 2.0, n)
    bp = b if sym.perm is None else b[sym.perm.perm.cpu().numpy()]
    xp = solve(torch.from_numpy(bp).to(a.device, dtype)).double().cpu().numpy()
    x = xp if sym.perm is None else xp[sym.perm.inv.cpu().numpy()]
    a_sp = a.to_scipy().astype(np.float64)
    r = a_sp @ x - b
    a_norm = float(abs(a_sp).sum(axis=1).max())
    return float(np.abs(r).max() / (a_norm * np.abs(x).max() + np.abs(b).max()))


def gate(out, name, a, sym, solve, dtype):
    """Record the backward error of ``solve`` as ``<name>_backward_error``;
    raise when it is over the limit."""
    err = backward_error(a, sym, solve, dtype)
    out[f"{name}_backward_error"] = err
    if not err <= BACKWARD_ERROR_LIMIT[dtype]:
        raise AssertionError(
            f"ldl bench: {name} backward error {err!r} over {BACKWARD_ERROR_LIMIT[dtype]!r}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--scan-grid", type=int, default=None,
                    help="grid for the row-scan baseline (defaults to --grid)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--scan-iters", type=int, default=2)
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES))
    ap.add_argument("--fill", default="rcm", choices=["rcm", "camd", "nd", "none"])
    ap.add_argument("--rel-zeros", type=float, default=0.65)
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-seq", action="store_true",
                    help="skip the sequential supernodal variant (batched only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    dtype = DTYPES[args.dtype]

    out = {"backend": device.type, "card": card() if device.type == "cuda" else None,
           "grid": args.grid, "dtype": args.dtype}

    def dump():
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f)
                f.write("\n")

    h = health_reference(device)
    out["health_us"] = h * 1e6
    print(f"# health reference: {h * 1e6:.0f} us/iter", flush=True)

    mat, sym, a, t_sym = prep(args.grid, args.fill, device)
    out["fill"] = args.fill
    n = sym.n
    out["n"] = n
    out["lnz"] = sym.nnz
    out["t_symbolic_s"] = t_sym
    dump()
    t0 = time.perf_counter()
    plan = build_super_plan(sym, rel_zeros=args.rel_zeros)
    out["t_plan_s"] = time.perf_counter() - t0
    out["snodes"] = plan.S
    out["W"] = plan.W
    out["MR"] = plan.MR
    out["tasks"] = plan.n_tasks
    out["panel_MB"] = plan.P * dtype.itemsize / 1e6
    fl = useful_flops(sym)
    out["useful_gflop"] = fl / 1e9
    print(f"# n={n} lnz={sym.nnz} snodes={plan.S} W={plan.W} MR={plan.MR} "
          f"tasks={plan.n_tasks} useful_gflop={fl / 1e9:.2f}", flush=True)

    data = a.data.to(dtype)

    if not args.skip_seq:
        def super_step(d):
            lx, dd = numeric_supernodal(plan, d)
            return d + 0.0 * dd[0] * lx[0]

        t_sup = chain_time_best(super_step, data, iters=args.iters, rounds=3)
        out["supernodal_s"] = t_sup
        out["supernodal_gflops"] = fl / t_sup / 1e9
        lx, dd = numeric_supernodal(plan, data)
        gate(out, "supernodal", a, sym, lambda v: flat_solve(sym, lx, dd, v), dtype)
        print(f"supernodal: {t_sup * 1e3:.1f} ms/refactor ({fl / t_sup / 1e9:.1f} useful GFLOP/s)",
              flush=True)
        dump()

    # level-batched rounds over the same plan
    t0 = time.perf_counter()
    sched = build_round_schedule(plan)
    out["t_sched_s"] = time.perf_counter() - t0
    out["rounds"] = sched.R
    print(f"# batched schedule: R={sched.R} rounds ({plan.n_tasks} tasks)", flush=True)

    def batched_step(pl, sc):
        def step(d):
            lx, dd = numeric_batched(pl, sc, d)
            return d + 0.0 * dd[0] * lx[0]
        return step

    t_bat = chain_time_best(batched_step(plan, sched), data, iters=args.iters, rounds=3)
    out["batched_s"] = t_bat
    out["batched_gflops"] = fl / t_bat / 1e9
    print(f"batched-super: {t_bat * 1e3:.1f} ms/refactor ({fl / t_bat / 1e9:.1f} useful GFLOP/s)",
          flush=True)
    dump()

    t0 = time.perf_counter()
    mfp = build_mf_plan(sym, rel_zeros=args.rel_zeros)
    msched = build_round_schedule(mfp)
    out["t_mf_plan_s"] = time.perf_counter() - t0
    out["mf_tasks"] = mfp.n_tasks
    out["mf_rounds"] = msched.R
    t_mf = chain_time_best(batched_step(mfp, msched), data, iters=args.iters, rounds=3)
    out["batched_mf_s"] = t_mf
    out["batched_mf_gflops"] = fl / t_mf / 1e9
    lx, dd = numeric_batched(mfp, msched, data)
    gate(out, "batched_mf", a, sym, lambda v: flat_solve(sym, lx, dd, v), dtype)
    print(f"batched-mf: {t_mf * 1e3:.1f} ms/refactor ({fl / t_mf / 1e9:.1f} useful GFLOP/s) "
          f"R={msched.R}", flush=True)
    dump()

    # solve timings: panel, level-scheduled and flat sweeps of the batched
    # factor (the permutation gathers, the same for all, left out)
    lx_b, d_b = numeric_batched(plan, sched, data)
    num = LdlNumeric(sym, lx_b, d_b)
    b0 = torch.from_numpy(np.linspace(1.0, 2.0, n).astype(np.float32)).to(device, dtype)
    panels = panels_from_csc(plan, num.l_data)

    def levels_solve(v):
        lo, up = sym.level_plans(device)
        return up.solve(num.l_data, lo.solve(num.l_data, v) / num.d)

    solvers = {"super": lambda v: solve_supernodal(plan, panels, num.d, v),
               "flat": lambda v: flat_solve(sym, num.l_data, num.d, v)}
    # the padded level solve's gather is n × (widest row): past 2^24 the
    # flat solve covers it
    w_pad = max(int(np.diff(sym.lcsr_indptr).max(initial=1)), int(np.diff(sym.l_indptr).max(initial=1)))
    if n * w_pad <= (1 << 24):
        solvers["levels"] = levels_solve
    else:
        out["solve_levels_s"] = None
        out["solve_levels_skip"] = f"padded n*w = {n}*{w_pad} > 2^24 — flat path covers it"
        print(f"solve[levels]: pre-skipped ({out['solve_levels_skip']})", flush=True)
    for meth, solver in solvers.items():
        # chained: each solve's right-hand side is the last x, scaled
        t_sol = chain_time_best(lambda v, s=solver: s(v / (1.0 + v[0].abs())), b0,
                                iters=max(args.iters, 5), rounds=3)
        out[f"solve_{meth}_s"] = t_sol
        gate(out, f"batched_solve_{meth}", a, sym, solver, dtype)
        print(f"solve[{meth}]: {t_sol * 1e3:.2f} ms", flush=True)
        dump()

    # external host baseline: scipy splu (f64) factor + solve wall-clock
    t_ext = _scipy_baseline(a, n)
    out.update(t_ext)
    print(f"scipy splu: factor {t_ext['scipy_splu_factor_s'] * 1e3:.1f} ms, "
          f"solve {t_ext['scipy_splu_solve_s'] * 1e3:.2f} ms", flush=True)
    dump()

    # row-scan baseline (optionally on a smaller grid: the per-flop time
    # is compared)
    if args.scan_iters > 0:
        sg = args.scan_grid or args.grid
        if sg == args.grid:
            sym2, a2, fl2 = sym, a, fl
        else:
            _, sym2, a2, _ = prep(sg, device=device)
            fl2 = useful_flops(sym2)
        out["scan_grid"] = sg

        def scan_step(d):
            lx, dd = _numeric_device(sym2, d)
            return d + 0.0 * dd[0] * lx[0]

        d2 = a2.data.to(dtype)
        t_scan = chain_time_best(scan_step, d2, iters=args.scan_iters, rounds=1)
        out["scan_s"] = t_scan
        out["scan_gflops"] = fl2 / t_scan / 1e9
        lx, dd = _numeric_device(sym2, d2)
        gate(out, "scan", a2, sym2, lambda v: flat_solve(sym2, lx, dd, v), dtype)
        t_ref = out.get("supernodal_s") or out["batched_s"]
        speedup = (t_scan / fl2) / (t_ref / fl)
        out["speedup_per_flop"] = speedup
        if sg == args.grid:
            out["speedup"] = t_scan / t_ref
        print(f"row-scan (grid {sg}): {t_scan * 1e3:.1f} ms/refactor "
              f"({fl2 / t_scan / 1e9:.2f} useful GFLOP/s)", flush=True)
        print(f"speedup (per-flop normalized): {speedup:.1f}x", flush=True)
    print(json.dumps(out), flush=True)
    dump()
    return out


if __name__ == "__main__":
    main()
