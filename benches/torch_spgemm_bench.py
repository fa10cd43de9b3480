"""SpGEMM benchmark: density and shape sweeps against scipy.sparse, the
counterpart of ``benches/spgemm_bench.py`` for the PyTorch/CUDA port.

The sweeps are the JAX bench's (after the Rust library's sprs-benches
harness): a density sweep over (1500, 2500) @ (2500, 1500) and (15000,
25000) @ (25000, 15000), and a square shape sweep at 4 entries per row.
Each point times the port's ``spgemm`` (ESC) on its device, its dense
route where the dense operands fit, ``torch.sparse.mm`` on the same CSR
tensors (the library yardstick), scipy's ``a @ b`` and the port's native
Gustavson ``native.spgemm_host`` on the host.  C must equal scipy's
pattern exactly, its data within rtol 1e-4 / atol 1e-5; a point that
does not fails the run after the record is printed.

Device products are timed as ``y = step(y, b)`` chains whose steps depend
on the previous product, between CUDA events
(``utils/profile.py::chain_time_best``): 5 products, best of 2 rounds,
and 8, best of 3 (the JAX bench's host-chained and fused timings); host
products as the best of ``--scipy-reps`` calls of scipy and of the
native library (scipy's last product is the reference C is held to;
``--scipy-reps 0`` calls scipy once and leaves the native library
untimed).

Run from the repository root on a machine with one GPU:
``python3 benches/torch_spgemm_bench.py [--quick] [--out results.json]``;
``--device cpu`` runs the port on the CPU (points over 2e7 partial
products skipped there, as the JAX bench skips them off the TPU).  Prints
one JSON line per point, then a summary line.
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
from sprs_tpu_torch import native  # noqa: E402
from sprs_tpu_torch.formats.csmat import CsMat  # noqa: E402
from sprs_tpu_torch.ops.spgemm import (  # noqa: E402
    _exact_prod_count,
    dense_bytes_budget,
    spgemm,
    spgemm_dense,
)
from sprs_tpu_torch.utils.profile import _Clock, bench_device, card, chain_time_best  # noqa: E402
from sprs_tpu_torch.utils.rand import rand_csr  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
CPU_PRODUCT_BUDGET = 2e7


def _time_host(fn, reps: int = 5):
    """(best seconds of ``reps`` host calls (scipy, the native library),
    the last call's result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _time_device(step, a0, b, iters: int, rounds: int) -> float:
    """Seconds per product of ``iters`` chained products y = step(y, b),
    the best of ``rounds`` rounds after one product.  The chain carries
    (data, matrix) pairs, whose first leaf the timer reads."""

    def pair_step(state):
        y = step(state[1], b)
        return y.data, y

    return chain_time_best(pair_step, (a0.data, a0), iters=iters, rounds=rounds)


def _time_device_chained(step, a0, b):
    """The JAX bench's host-chained timing: 5 products, best of 2."""
    return _time_device(step, a0, b, 5, 2)


def _time_device_fori(step, a0, b):
    """The JAX bench's fused timing (``fori_loop``): 8 products, best of
    3.  On the card both are the same chain between CUDA events."""
    return _time_device(step, a0, b, 8, 3)


def _time_library(fn, like, reps: int = 5) -> float:
    """Best seconds of ``reps`` single calls of ``fn`` after one call,
    the clock set by the tensor ``like`` (``fn``'s result, which may be
    empty, is not read)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        clock = _Clock(like)
        clock.start()
        fn()
        best = min(best, clock.stop(like))
    return best


def _dependency_step(f):
    """step(a, b) = a + 0·indicator(f(a, b)): each product depends on the
    previous one without changing values."""

    def step(a, b):
        c = f(a, b)
        dep = torch.where(torch.isnan(c.data.reshape(-1)[0]), 1.0, 0.0).to(a.data.dtype)
        return CsMat(a.indptr, a.indices, a.data + dep, a.shape, a.storage)

    return step


def _csr_tensor(mat):
    nnz = mat.nnz
    return torch.sparse_csr_tensor(mat.indptr, mat.indices[:nnz], mat.data[:nnz], size=mat.shape)


def operands(shape_a, shape_b, density, seed=0, device="cuda"):
    """The JAX bench's operands: ``rand_csr`` float32 at seeds seed and
    seed + 1."""
    a = rand_csr(shape_a, density, seed=seed, dtype=np.float32, device=device)
    b = rand_csr(shape_b, density, seed=seed + 1, dtype=np.float32, device=device)
    return a, b


def equals_scipy(c, ref) -> bool:
    """C's indptr and indices equal scipy's sorted result, its data within
    rtol 1e-4 / atol 1e-5."""
    ref = ref.copy()
    ref.sort_indices()
    nnz = c.nnz
    data = c.data[:nnz].cpu().numpy()
    return bool(
        np.array_equal(c.indptr.cpu().numpy(), ref.indptr)
        and np.array_equal(c.indices[:nnz].cpu().numpy(), ref.indices)
        and np.allclose(data, ref.data, rtol=RTOL, atol=ATOL)
    )


def bench_one(shape_a, shape_b, density, seed=0, *, device="cuda", scipy_reps=5):
    """One point of the sweep: scipy's product (timed, the best of
    ``scipy_reps`` calls, at least one: it is the reference C must equal)
    and the native Gustavson's (the best of ``scipy_reps`` calls; 0 leaves
    it untimed), then the port's routes on the card."""
    device = torch.device(device)
    a, b = operands(shape_a, shape_b, density, seed, device)
    a_sp = a.to_scipy().tocsr()
    b_sp = b.to_scipy().tocsr()

    t_scipy, c_ref = _time_host(lambda: a_sp @ b_sp, max(scipy_reps, 1))

    # second host baseline: the native Gustavson (Eigen-class, C++)
    t_native = None
    if native.available() and scipy_reps > 0:
        t_native, _ = _time_host(
            lambda: native.spgemm_host(a_sp.indptr, a_sp.indices, a_sp.data, b_sp.indptr,
                                       b_sp.indices, b_sp.data, b_sp.shape[1]),
            scipy_reps,
        )

    out_cap = max(int(c_ref.nnz), 1)
    m, k = shape_a
    n = shape_b[1]
    dense_fits = (m * k + k * n + m * n) * 4 <= dense_bytes_budget(device)
    t_dense = t_dense_fori = dense_ok = None
    if dense_fits:
        f_dense = lambda a, b: spgemm_dense(a, b, out_cap=out_cap)  # noqa: E731
        c_d = f_dense(a, b)
        dense_step = _dependency_step(f_dense)
        t_dense = _time_device_chained(dense_step, a, b)
        t_dense_fori = _time_device_fori(dense_step, a, b)
        if m * n <= 1e7:
            dense_ok = bool(np.allclose(c_d.to_dense().cpu().numpy(), c_ref.toarray(), rtol=RTOL, atol=ATOL))
        del c_d

    row = dict(
        shape_a=list(shape_a),
        shape_b=list(shape_b),
        density=density,
        nnz_a=int(a.nnz),
        nnz_b=int(b.nnz),
        nnz_c=int(c_ref.nnz),
        scipy_s=t_scipy,
        native_gustavson_s=t_native,
        dense_s=t_dense,
        dense_fori_s=t_dense_fori,
        dense_equal=dense_ok,
        dense_speedup_vs_scipy=t_scipy / t_dense if t_dense else None,
        dense_fori_speedup_vs_scipy=t_scipy / t_dense_fori if t_dense_fori else None,
        backend=device.type,
    )
    prod_cap = max(_exact_prod_count(a, b), 1)
    row["products"] = prod_cap
    if device.type != "cuda" and prod_cap > CPU_PRODUCT_BUDGET:
        row["skipped"] = f"partial products {prod_cap} exceed budget {CPU_PRODUCT_BUDGET:g}"
        return row
    f = lambda a, b: spgemm(a, b, out_cap=out_cap, prod_cap=prod_cap, check_capacity=False)  # noqa: E731
    c = f(a, b)
    esc_step = _dependency_step(f)
    t_sprs = _time_device_chained(esc_step, a, b)
    t_sprs_fori = _time_device_fori(esc_step, a, b)
    ok = equals_scipy(c, c_ref)
    del c

    t_lib = lib_nnz = None
    if device.type == "cuda":
        ta, tb = _csr_tensor(a), _csr_tensor(b)
        lib_nnz = int(torch.sparse.mm(ta, tb)._nnz())
        t_lib = _time_library(lambda: torch.sparse.mm(ta, tb), a.data)
    row.update(
        sprs_tpu_torch_s=t_sprs,
        sprs_tpu_torch_fori_s=t_sprs_fori,
        library_s=t_lib,
        library="torch.sparse.mm (CSR @ CSR)" if t_lib else None,
        library_nnz=lib_nnz,
        speedup_vs_scipy=t_scipy / t_sprs if t_sprs > 0 else None,
        fori_speedup_vs_scipy=t_scipy / t_sprs_fori if t_sprs_fori > 0 else None,
        speedup_vs_native=t_native / t_sprs if t_native and t_sprs > 0 else None,
        speedup_vs_library=t_lib / t_sprs if t_lib and t_sprs > 0 else None,
        equal=ok,
    )
    return row


def sweeps(quick: bool):
    """(density sweep, shape sweep) specs of the JAX bench."""
    density_shapes = [(1500, 2500), (15000, 25000)]
    densities = [1e-5, 1e-4, 1e-3, 5e-3] if quick else [1e-6, 1e-5, 1e-4, 1e-3, 5e-3, 1e-2]
    density_specs = [
        {"shape_a": [rows, cols], "shape_b": [cols, rows], "density": d}
        for rows, cols in density_shapes
        for d in densities
        if d * rows * cols <= 5e6
    ]
    sides = [1500, 15000] if quick else [1500, 15000, 150000]
    shape_specs = [{"shape_a": [n, n], "shape_b": [n, n], "density": 4.0 / n} for n in sides]
    return density_specs, shape_specs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scipy-reps", type=int, default=5,
                    help="calls of scipy and the native library per point (the best is kept); "
                         "0: scipy once (its product is the reference), the native library not timed")
    args = ap.parse_args(argv)
    device = bench_device(args.device)

    results = {"backend": device.type, "card": card() if device.type == "cuda" else None,
               "density_sweep": [], "shape_sweep": []}

    def flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
                f.write("\n")

    for specs, key in zip(sweeps(args.quick), ("density_sweep", "shape_sweep")):
        for s in specs:
            r = bench_one(tuple(s["shape_a"]), tuple(s["shape_b"]), s["density"], device=device,
                          scipy_reps=args.scipy_reps)
            results[key].append(r)
            print(json.dumps(r), flush=True)
            flush()

    rows_all = results["density_sweep"] + results["shape_sweep"]
    results["all_equal"] = all(r.get("equal", True) and r["dense_equal"] is not False for r in rows_all)
    flush()
    print(json.dumps({"all_equal": results["all_equal"], "backend": results["backend"]}))
    if not results["all_equal"]:
        raise AssertionError("spgemm bench: a product differs from scipy's")
    return results


if __name__ == "__main__":
    main()
