"""Large-scale LDLᵀ end to end, the counterpart of ``benches/ldl_big.py``
for the PyTorch/CUDA port: symbolic → plan → round schedule → batched
factor → panel solves, with the record written after every stage
(``--json``), so a run cut short keeps what it reached.

On the Dirichlet Laplacian of a ``--grid``² grid (512² = 262,144 rows by
default; ``--grid 1024 --plan-only`` for the host stages at 1M rows):

* host stages, with their seconds and sizes: the symbolic factor (``n``,
  ``lnz``, ``useful_gflop``), the multifrontal or supernodal plan
  (``--kind``; ``S, W, MR, P, tasks`` and the agg table's, panels' and
  row map's MB) and its round schedule (``rounds, Bu, Bf``);
* on the device, in float32: the round-batched factor
  (``ldl_batched.numeric_batched``) as a chain of refactorizations
  (``utils/profile.py::chain_time_best``, ``--iters`` per round, best of
  3), with useful GFLOP/s; with ``--profile``, the torch ops one factor
  issues (a dispatch mode) and, on a card, its device launches, busy ms
  and idle share under ``torch.profiler``;
* the sequential panel solve (``ldl_super.solve_supernodal``) and the
  round-batched one (``ldl_batched.solve_batched``) of that factor, as
  chained solves, and their largest difference;
* the verdict: the relative backward error
  ‖Ax − 1‖∞ / (‖A‖∞‖x‖∞ + 1) of the panel solve of b = 1, with the
  residual taken in float64, against ``--rtol``;
* the flat solve (``benches/torch_ldl_bench.py::flat_solve``, the sweeps
  over ``LdlSymbolic.flat_plans``; ``--no-flat`` leaves it out), timed
  and held against the panel solve;
* scipy's ``splu`` on the host in float64, and the forward error of the
  device's x against it;
* the factor against the exact float64 host numeric
  (``LdlNumeric.factor(..., backend="host")``; ``--host-check auto``: on
  for n ≤ 300,000).

Record keys against the JAX bench's: ``backend`` is the torch device
type; added are ``card``, ``solve_y_inf`` (max|y| of the sequential
solve, the scale of ``solve_batched_max_diff``) and, with
``--profile``, ``factor_torch_ops``, ``factor_device_launches``,
``factor_launches_per_round``, ``factor_device_busy_ms``,
``factor_traced_ms``, ``factor_device_idle_share`` and
``factor_top_device_ops``; a stage that raises records its message as
``<stage>_error`` beside the JAX bench's None.  Sizes keep the JAX
bench's rounding; times are unrounded seconds.

Run from the repository root on a machine with one GPU:
``python3 benches/torch_ldl_big.py [--grid 512] [--fill nd] [--kind mf]
[--json out.json] [--profile]``, or ``--grid 1024 --plan-only``;
``--device cpu`` runs it on the CPU.  Prints progress lines, then the
record as one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sprs_tpu_torch.linalg import Ldl  # noqa: E402
from sprs_tpu_torch.linalg.ldl import LdlNumeric  # noqa: E402
from sprs_tpu_torch.linalg.ldl_batched import (  # noqa: E402
    build_round_schedule,
    numeric_batched,
    solve_batched,
)
from sprs_tpu_torch.linalg.ldl_mf import build_mf_plan  # noqa: E402
from sprs_tpu_torch.linalg.ldl_super import (  # noqa: E402
    build_super_plan,
    panels_from_csc,
    solve_supernodal,
)
from sprs_tpu_torch.ops.prod import spmv  # noqa: E402
from sprs_tpu_torch.utils.profile import (  # noqa: E402
    bench_device,
    card,
    chain_time_best,
    device_launches,
    torch_ops,
)
from sprs_tpu_torch.utils.special import dirichlet_laplacian  # noqa: E402


def _flat_solve():
    """``flat_solve`` of ``benches/torch_ldl_bench.py``, loaded by path."""
    path = Path(__file__).resolve().parent / "torch_ldl_bench.py"
    spec = importlib.util.spec_from_file_location("torch_ldl_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.flat_solve


def chained(step, x0, iters: int):
    """(the first output of ``step``, the least of 3 rounds of seconds per
    step of ``iters`` chained steps after it)."""
    first = []

    def keep(v):
        y = step(v)
        if not first:
            first.append(y)
        return y

    t = chain_time_best(keep, x0, iters=iters, rounds=3)
    return first[0], t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--fill", default="nd", choices=["nd", "camd", "rcm"])
    ap.add_argument("--rel-zeros", type=float, default=0.85)
    ap.add_argument("--max-width", type=int, default=128)
    ap.add_argument("--kind", default="mf", choices=["mf", "super"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--plan-only", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--panel-limit", type=int, default=1 << 28)
    ap.add_argument("--map-limit", type=int, default=1 << 27)
    ap.add_argument("--agg-limit", type=int, default=1 << 28)
    ap.add_argument(
        "--rtol", type=float, default=2e-3,
        help="pass bar on the relative backward error "
        "||Ax-b||inf/(||A||inf*||x||inf+||b||inf); f32 LDL accumulates over "
        "column lengths up to MR (~1e3 here), so the expected scale is "
        "O(eps_f32 * MR) ~ 1e-4; 2e-3 leaves a 10-20x margin")
    ap.add_argument("--no-flat", action="store_true", help="skip the flat-solve timing and cross-check")
    ap.add_argument(
        "--host-check", default="auto", choices=["auto", "on", "off"],
        help="cross-check the device factor against the exact f64 host numeric "
        "(auto: on for n <= 300k)")
    ap.add_argument("--profile", action="store_true",
                    help="count one factor's torch ops, and on a card profile its launches")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)

    out = {"grid": args.grid, "fill": args.fill, "kind": args.kind}

    def dump():
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f)
                f.write("\n")

    out["backend"] = device.type
    out["card"] = card() if device.type == "cuda" else None
    print(f"# backend={out['backend']} card={out['card']}", flush=True)

    t0 = time.perf_counter()
    mat = dirichlet_laplacian((args.grid, args.grid), device=device)
    sym = Ldl().fill_in_reduction(args.fill).check_symmetry(False).symbolic(mat)
    out["t_symbolic_s"] = time.perf_counter() - t0
    out["n"] = sym.n
    out["lnz"] = sym.nnz
    c = np.diff(np.asarray(sym.l_indptr)) - 1
    fl = float(np.sum(c * (c + 2.0)))
    out["useful_gflop"] = round(fl / 1e9, 3)
    print(f"# n={sym.n} lnz={sym.nnz} gflop={fl / 1e9:.2f} sym={out['t_symbolic_s']:.2f}s", flush=True)
    dump()

    t0 = time.perf_counter()
    kw = dict(max_width=args.max_width, rel_zeros=args.rel_zeros, panel_limit=args.panel_limit,
              map_limit=args.map_limit)
    if args.kind == "mf":
        plan = build_mf_plan(sym, agg_limit=args.agg_limit, **kw)
        out["agg_table_MB"] = round(plan.agg_table_elems * 4 / 1e6, 1)
    else:
        plan = build_super_plan(sym, **kw)
    out["t_plan_s"] = time.perf_counter() - t0
    out["S"] = plan.S
    out["W"] = plan.W
    out["MR"] = plan.MR
    out["P"] = plan.P
    out["tasks"] = plan.n_tasks
    out["panel_MB"] = round(plan.P * 4 / 1e6, 1)
    out["rmap_MB"] = round(plan.t_rmap.size * 4 / 1e6, 1)
    print(f"# plan: S={plan.S} W={plan.W} MR={plan.MR} T={plan.n_tasks} "
          f"panel={out['panel_MB']}MB rmap={out['rmap_MB']}MB agg={out.get('agg_table_MB')}MB "
          f"({out['t_plan_s']:.2f}s)", flush=True)
    dump()

    t0 = time.perf_counter()
    sched = build_round_schedule(plan)
    out["t_sched_s"] = time.perf_counter() - t0
    out["rounds"] = sched.R
    out["Bu"] = sched.Bu
    out["Bf"] = sched.Bf
    print(f"# schedule: R={sched.R} Bu={sched.Bu} Bf={sched.Bf} ({out['t_sched_s']:.2f}s)",
          flush=True)
    dump()
    if args.plan_only:
        print(json.dumps(out), flush=True)
        return out

    a = mat.to_csr()
    data = a.data.to(torch.float32)

    def batched_step(d):
        lx, dd = numeric_batched(plan, sched, d)
        return d + 0.0 * dd[0] * lx[0]

    t_fac = chain_time_best(batched_step, data, iters=args.iters, rounds=3)
    out["factor_s"] = t_fac
    out["factor_gflops"] = fl / t_fac / 1e9
    print(f"batched factor: {t_fac * 1e3:.1f} ms ({fl / t_fac / 1e9:.2f} GFLOP/s)", flush=True)
    dump()

    if args.profile:
        factor = lambda: numeric_batched(plan, sched, data)  # noqa: E731
        out["factor_torch_ops"] = torch_ops(factor)
        if device.type == "cuda":
            launches, busy, wall, top = device_launches(factor)
            out.update(factor_device_launches=launches, factor_launches_per_round=launches / sched.R,
                       factor_device_busy_ms=busy, factor_traced_ms=wall,
                       factor_device_idle_share=1.0 - busy / wall, factor_top_device_ops=top)
        print(f"factor profile: {json.dumps({k: v for k, v in out.items() if k.startswith('factor_')})}",
              flush=True)
        dump()

    # the sequential panel solve of the batched factor
    lx, d = numeric_batched(plan, sched, data)
    panels = panels_from_csc(plan, lx)
    b0 = torch.from_numpy(np.linspace(1.0, 2.0, sym.n).astype(np.float32)).to(device)
    iters = max(args.iters, 3)
    y, best = chained(lambda v: solve_supernodal(plan, panels, d, v / (1.0 + v[0].abs())), b0, iters)
    out["solve_s"] = best
    print(f"panel solve: {best * 1e3:.2f} ms", flush=True)
    dump()

    # the round-batched panel solve: the factor's rounds as the solve's
    # level schedule, R steps a sweep instead of S
    yb, best_b = chained(lambda v: solve_batched(plan, sched, panels, d, v / (1.0 + v[0].abs())),
                         b0, iters)
    out["solve_batched_max_diff"] = float((yb - y).abs().max())
    out["solve_y_inf"] = float(y.abs().max())
    out["solve_batched_s"] = best_b
    print(f"batched solve: {best_b * 1e3:.2f} ms (x{best / best_b:.2f} vs sequential; "
          f"diff {out['solve_batched_max_diff']:.2e})", flush=True)
    dump()

    # ---- correctness: relative backward error with a pass bar --------
    ones = torch.ones(sym.n, dtype=torch.float32, device=device)
    bb = ones if sym.perm is None else ones[sym.perm.perm.to(torch.int64)]
    xs = solve_supernodal(plan, panels, d, bb)
    if sym.perm is not None:
        xs = xs[sym.perm.inv.to(torch.int64)]
    x_np = xs.double().cpu().numpy()
    r = spmv(mat, xs.to(mat.dtype)).double().cpu().numpy() - 1.0
    # ||A||inf on the host over the live entries
    ip = a.indptr.cpu().numpy().astype(np.int64)
    nnz_a = int(ip[-1])
    da = np.abs(a.data[:nnz_a].double().cpu().numpy())
    norm_a = float(np.bincount(np.repeat(np.arange(sym.n), np.diff(ip)), weights=da,
                               minlength=sym.n).max())
    denom = norm_a * np.abs(x_np).max() + 1.0
    out["residual_inf"] = float(np.abs(r).max())
    out["residual_rel"] = float(np.abs(r).max() / denom)
    out["norm_a_inf"] = norm_a
    out["norm_x_inf"] = float(np.abs(x_np).max())
    out["residual_ok"] = bool(out["residual_rel"] < args.rtol)
    print(f"residual_inf={out['residual_inf']:.3e} rel={out['residual_rel']:.3e} "
          f"(bar {args.rtol:.0e}) ok={out['residual_ok']}", flush=True)
    dump()

    # the flat O(lnz) stream solve, after the verdict
    if not args.no_flat:
        try:
            flat_solve = _flat_solve()
            t0 = time.perf_counter()
            sym.flat_scheds()
            sym.flat_plans(device)
            out["t_flat_sched_s"] = time.perf_counter() - t0
            _, best_f = chained(lambda v: flat_solve(sym, lx, d, v / (1.0 + v[0].abs())), b0, iters)
            out["solve_flat_s"] = best_f
            print(f"flat solve: {best_f * 1e3:.2f} ms", flush=True)
            # two independent solve paths must agree to f32 rounding
            xf = flat_solve(sym, lx, d, bb)
            if sym.perm is not None:
                xf = xf[sym.perm.inv.to(torch.int64)]
            dx = float(np.abs(xf.double().cpu().numpy() - x_np).max())
            out["flat_vs_panel_inf"] = dx
            out["flat_vs_panel_rel"] = dx / (np.abs(x_np).max() + 1.0)
            print(f"flat-vs-panel rel diff {out['flat_vs_panel_rel']:.3e}", flush=True)
        except Exception as e:  # the JAX bench's record: None and go on
            out["solve_flat_s"] = None
            out["solve_flat_error"] = repr(e)
            print(f"flat solve failed: {e!r}", flush=True)
        dump()

    # ---- external f64 baseline + forward-error cross-check -----------
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        A = sp.csc_matrix(
            (a.data[:nnz_a].double().cpu().numpy(), a.indices[:nnz_a].cpu().numpy().astype(np.int64), ip),
            shape=(sym.n, sym.n))
        t0 = time.perf_counter()
        lu = spla.splu(A)
        out["scipy_splu_factor_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_ref = lu.solve(np.ones(sym.n))
        out["scipy_splu_solve_s"] = time.perf_counter() - t0
        out["scipy_splu_lnz"] = int(lu.L.nnz + lu.U.nnz)
        r_ref = A @ x_ref - 1.0
        out["scipy_rel_resid"] = float(np.abs(r_ref).max() / (norm_a * np.abs(x_ref).max() + 1.0))
        # forward error of the device's x against the f64 reference, up to
        # cond(A)·residual_rel
        out["fwd_err_rel"] = float(np.abs(x_np - x_ref).max() / np.abs(x_ref).max())
        print(f"scipy splu: factor {out['scipy_splu_factor_s']:.2f}s "
              f"solve {out['scipy_splu_solve_s'] * 1e3:.1f}ms lnz={out['scipy_splu_lnz']} "
              f"fwd_err_rel={out['fwd_err_rel']:.3e}", flush=True)
    except Exception as e:
        out["scipy_splu_factor_s"] = None
        out["scipy_splu_error"] = repr(e)
        print(f"scipy baseline failed: {e!r}", flush=True)
    dump()

    # ---- exact f64 host-factor cross-check ----------------------------
    hc = args.host_check
    if hc == "auto":
        hc = "on" if sym.n <= 300_000 else "off"
    if hc == "on":
        try:
            t0 = time.perf_counter()
            num_h = LdlNumeric.factor(sym, mat, backend="host")
            out["t_host_factor_s"] = time.perf_counter() - t0
            d_h = num_h.d.double().cpu().numpy()
            d_t = d.double().cpu().numpy()
            out["d_rel_err"] = float(np.abs(d_t - d_h).max() / np.abs(d_h).max())
            l_h = num_h.l_data.double().cpu().numpy()
            l_t = lx.double().cpu().numpy()
            out["l_rel_err"] = float(np.abs(l_t - l_h).max() / (np.abs(l_h).max() + 1.0))
            out["factor_ok"] = bool(out["d_rel_err"] < 1e-2 and out["l_rel_err"] < 1e-2)
            print(f"host f64 cross-check: d_rel_err={out['d_rel_err']:.3e} "
                  f"l_rel_err={out['l_rel_err']:.3e} ok={out['factor_ok']} "
                  f"({out['t_host_factor_s']:.2f}s)", flush=True)
        except Exception as e:
            out["factor_ok"] = None
            out["host_check_error"] = repr(e)
            print(f"host cross-check failed: {e!r}", flush=True)
        dump()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
