"""Kernel timing and roofline audit, the counterpart of
``sprs_tpu/utils/profile.py``.

* :func:`chain_time` — wall-clock of a chained ``y = f(y)`` loop.  On a
  CUDA tensor the loop is timed by CUDA events recorded around it on the
  current stream, then the stream is synchronised; on the CPU by
  ``time.perf_counter``.
* :func:`measure_peak_bandwidth` — achievable streaming bandwidth of a
  saturating a*x+b, the denominator of every roofline fraction.
* byte accounting per format (the least traffic of one SpMV: each byte
  once), the same integers as the JAX package's, and
  :func:`roofline_report` tying them together.
* :func:`trace` — a ``torch.profiler`` context writing a Chrome trace.
  Beside the device timeline it holds the library's own spans
  (:func:`span`), which mark where its host time goes:

  - ``sprs.cg.sync``: each host read of a device value in
    ``linalg.cg`` (the loop's convergence test, then ``converged`` and
    the final residual norm);
  - ``sprs.bicgstab.sync``: the same in ``linalg.bicgstab``;
  - ``sprs.k1``: K1's direct launch through a prepared DIA operand's
    plan (checks, the output's allocation, the launch);
  - ``sprs.k5``: a product through K5 (the shape check and the
    autograd ``Function`` with its launch);
  - ``sprs.k7``: a CSR product through K7 (the checks, the output's and
    the tiles' scratch allocations, the launch of its two kernels, or the
    plain product on the CPU);
  - ``sprs.index_sum``: :func:`~sprs_tpu_torch.formats.util.index_sum_`,
    the ordered scatter-add of the plain and CSC products, the SpMMs and
    the assembly (on a card the accumulating ``index_put_``: its sort
    and its sums);
  - ``sprs.coo_to_csmat``: the whole assembly of a CsMat from triplets;
  - ``sprs.prepare_spmv``: the routing rule, the chosen format's
    conversion and K1's plan.

  A span costs one check while no profiler records.
* :func:`bench_device` and :func:`card` — the device a bench runs on, and
  the card's name and power limit that every bench record carries.
* :func:`torch_ops` and :func:`device_launches` — the torch ops one call
  issues (a dispatch mode) and the device launches, busy and traced time
  of one call on a card (``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._span import span  # noqa: F401  (the documented entry)
from ..formats.util import DEFAULT_DEVICE


def bench_device(name: str) -> torch.device:
    """The device a bench was asked for.  A CUDA device with no card
    present raises: a bench never falls back to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA GPU: torch.cuda.is_available() is false, so the bench cannot run on "
            f"{name!r}; pass --device cpu to run its plain path on the CPU"
        )
    return device


def card() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def _first_tensor(y) -> torch.Tensor:
    """The first tensor leaf of ``y`` (a tensor, or a list, tuple or dict
    holding tensors)."""
    if isinstance(y, torch.Tensor):
        return y
    items = y.values() if isinstance(y, dict) else y
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def fetch_scalar(y) -> float:
    """Force completion by reading one element of the first tensor leaf
    back to the host."""
    return float(_first_tensor(y).reshape(-1)[0])


class _Clock:
    """Seconds between ``start`` and ``stop``: CUDA events on the device's
    current stream for a CUDA tensor, the host clock otherwise."""

    def __init__(self, like: torch.Tensor):
        self.cuda = like.device.type == "cuda"
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self, y) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.begin.elapsed_time(self.end) / 1e3
        fetch_scalar(y)
        return time.perf_counter() - self.t0


def chain_time(step: Callable, x0, iters: int = 50) -> float:
    """Per-iteration seconds of y = step(y), after one warm-up step."""
    fetch_scalar(step(x0))
    clock = _Clock(_first_tensor(x0))
    clock.start()
    y = x0
    for _ in range(iters):
        y = step(y)
    return clock.stop(y) / iters


def chain_time_best(step: Callable, x0, iters: int = 10, rounds: int = 3) -> float:
    """The least of ``rounds`` :func:`chain_time` rounds after one warm-up
    step."""
    fetch_scalar(step(x0))
    clock = _Clock(_first_tensor(x0))
    best = float("inf")
    for _ in range(rounds):
        clock.start()
        y = x0
        for _ in range(iters):
            y = step(y)
        best = min(best, clock.stop(y) / iters)
    return best


def fori_chain_time(step2: Callable, operand, x0, inner: int = 32, rounds: int = 3) -> float:
    """Per-iteration seconds of ``inner`` chained steps
    ``y = step2(operand, y)``, the least of ``rounds`` rounds.  The JAX
    package fuses the steps into one ``fori_loop`` dispatch; here they are
    a Python loop of ``inner`` steps, timed as one run."""
    fetch_scalar(step2(operand, x0))
    clock = _Clock(_first_tensor(x0))
    best = float("inf")
    for _ in range(rounds):
        clock.start()
        y = x0
        for _ in range(inner):
            y = step2(operand, y)
        best = min(best, clock.stop(y) / inner)
    return best


def torch_ops(fn) -> int:
    """The torch operations one call of ``fn`` issues, views excluded
    (each launches at least one kernel on the card), counted by a
    dispatch mode: cheap where the profiler takes about a millisecond
    per launch to trace."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def device_launches(fn):
    """(device ops launched by one call of ``fn``, device busy ms, traced
    wall ms, top ops as [name, count, ms]) from torch.profiler; a card
    only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    top = [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in ops[:8]]
    return sum(e.count for e in ops), busy, wall, top


def measure_peak_bandwidth(nbytes: int = 1 << 29, iters: int = 30, *,
                           device=DEFAULT_DEVICE) -> float:
    """Achievable streaming GB/s of a*x+b over ``nbytes`` of float32, read
    once and written once per step: one fused in-place kernel, as XLA
    fuses the JAX package's.  ``b`` is a host scalar tensor, which torch
    folds into its vectorized kernel; eager ``v * a + b`` would make two
    passes and two new buffers per step."""
    n = nbytes // 4
    x = torch.from_numpy(np.random.default_rng(3).random(n, dtype=np.float32)).to(device)
    b = torch.tensor(0.5, dtype=torch.float32)
    dt = chain_time(lambda v: torch.add(b, v, alpha=1.000001, out=v), x, iters)
    return 2.0 * nbytes / dt / 1e9


# ---------------------------------------------------------------------------
# the least traffic of one product per format (each byte once)
# ---------------------------------------------------------------------------


def csr_spmv_bytes(nnz: int, rows: int, val_bytes: int = 4, idx_bytes: int = 4) -> int:
    """data + indices streamed once, one x gather per nnz, y + indptr."""
    return nnz * (2 * val_bytes + idx_bytes) + rows * (val_bytes + idx_bytes)


def ell_spmv_bytes(rows_pad: int, width: int, cols: int, val_bytes: int = 4) -> int:
    return rows_pad * width * (val_bytes + 4) + (cols + rows_pad) * val_bytes


def dia_spmv_bytes(n_diags: int, rows: int, cols: int, val_bytes: int = 4) -> int:
    return (n_diags * rows + cols + rows) * val_bytes


def bsr_spmm_bytes(n_blocks: int, bs: int, k: int, n_block_rows: int, val_bytes: int = 4) -> int:
    return (n_blocks * bs * (bs + k) + n_block_rows * bs * k) * val_bytes


def roofline_report(
    name: str,
    seconds: float,
    useful_bytes: int,
    flops: int = 0,
    peak_gbps: float = None,
    *,
    device=DEFAULT_DEVICE,
) -> Dict:
    """A roofline record for one kernel measurement on ``device``."""
    if peak_gbps is None:
        peak_gbps = measure_peak_bandwidth(device=device)
    achieved = useful_bytes / seconds / 1e9
    return {
        "kernel": name,
        "seconds": seconds,
        "achieved_GBps": round(achieved, 2),
        "peak_GBps": round(peak_gbps, 2),
        "roofline_fraction": round(achieved / peak_gbps, 4),
        "gflops": round(flops / seconds / 1e9, 3) if flops else None,
        "backend": torch.device(device).type,
    }


@contextlib.contextmanager
def trace(log_dir: str = None):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card); the Chrome trace is written to ``log_dir/trace.json`` (default:
    ``sprs_tpu_torch_trace`` in the temporary directory)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "sprs_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def audit_spmv(mat, x=None, iters: int = 50) -> Dict:
    """Roofline audit of the best SpMV path for ``mat`` on its device.

    DIA when the matrix is banded (at most 32 diagonals) through K1; else
    ELL when its padding is below 1.0, through K5 on a CUDA operand and
    the plain ``ell_spmv`` on the CPU; else the CSR product
    ``ops/prod.py::spmv``.  The label names what ran.  ``x`` defaults to
    uniform [0, 1) numbers from ``default_rng(0)`` in the matrix's dtype.
    """
    from ..formats.dia import n_diags_of
    from ..formats.ell import ell_overhead, ell_spmv

    device = mat.device
    on_card = device.type == "cuda"
    prefix = "cuda" if on_card else "torch"
    n = mat.shape[1]
    if x is None:
        x = torch.from_numpy(np.random.default_rng(0).random(n, dtype=np.float32))
        x = x.to(device=device, dtype=mat.dtype)
    val_bytes = mat.dtype.itemsize
    peak = measure_peak_bandwidth(device=device)
    if n_diags_of(mat) <= 32:
        from ..ops.cuda.dia_spmv import dia_tile

        dia = dia_tile(mat.to_dia())
        dt = chain_time(dia.spmv, x, iters)
        return roofline_report(
            f"{prefix}_dia_spmv",
            dt,
            dia_spmv_bytes(dia.n_diags, dia.rows, dia.cols, val_bytes),
            flops=2 * dia.n_diags * dia.rows,
            peak_gbps=peak,
            device=device,
        )
    if ell_overhead(mat) < 1.0:
        ell = mat.to_ell()
        if on_card:
            from ..ops.cuda.ell_spmv import ell_spmv_kernel

            dt = chain_time(lambda v: ell_spmv_kernel(ell, v), x, iters)
        else:
            dt = chain_time(lambda v: ell_spmv(ell, v), x, iters)
        return roofline_report(
            f"{prefix}_ell_spmv",
            dt,
            ell_spmv_bytes(ell.rows_pad, ell.width, ell.cols, val_bytes),
            flops=2 * ell.rows_pad * ell.width,
            peak_gbps=peak,
            device=device,
        )
    from ..ops.prod import spmv

    dt = chain_time(lambda v: spmv(mat, v), x, iters)
    return roofline_report(
        "torch_csr_spmv",
        dt,
        csr_spmv_bytes(mat.nnz, mat.rows, val_bytes),
        flops=2 * mat.nnz,
        peak_gbps=peak,
        device=device,
    )
