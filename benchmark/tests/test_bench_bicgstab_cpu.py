"""The heat-example cell, ``poisson2d4096.bicgstab50``, on the CPU: its
four readers on traces made by hand, and whole runs at a tiny size (a
16 × 12 grid, sets of 10 iterations, far from round-off) where the
program agrees with the plain reference, the control (the program in
float32) comes out not correct, and so does each fault the cell can
have, planted in the program under the timed path: a solve that returns
x = 0, x = b or x = 1e-30·b (each with its true residual), a product
that drops half its rows, one entry of x altered, a solve handed the
previous request's b, a set cut to half its iterations or to one, a
wrong step (ω = 0, α halved), and the iterations run in float32 with
the final residual norm taken in float64."""

import importlib
import inspect
import io
import re
import time

import pytest
import torch

from calibrate import control_cell
from harness.loop import Context, run_cell
from harness.roofline import stencil_bytes
from harness.spec import BENCH_DIR, load_cell, load_module
from harness.trace import WINDOW_SPAN, Trace
from sprs_tpu_torch import linalg
from sprs_tpu_torch.ops import prod

CELL = "poisson2d4096.bicgstab50"
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("bicgstab_gap_us_per_iter", "bicgstab_sync_idle_us_per_iter",
           "bicgstab_update_ms_per_iter", "poisson_spmv_roofline")


def tiny_cell():
    cell = load_cell(CELL)
    cell.config = dict(cell.config, nx=16, ny=12)
    cell.traffic = dict(cell.traffic, iterations=10)
    return cell


def _run(cell, seed=2147483749, trace=False):
    log = io.StringIO()
    r = run_cell(cell, seed, 0.3, trace, "cpu", time.perf_counter(), log=log)
    return r, log.getvalue()


# -- the readers on a trace made by hand --------------------------------

def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "metric").read


def _ev(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(program=True):
    """Two ``bicgstab`` spans [base + 10, base + 960), each of two
    products in ``spmv`` spans (a 100 µs kernel starting 30 µs after its
    span), a 200 µs and a 50 µs update kernel, and two host reads in
    ``sprs.bicgstab.sync``: [12, 18) idle, [140, 160) whose first 10 µs
    the first product still runs.  ``program=False`` drops the program's
    spans, as a program without them records."""
    ev, corr = [_ev("user_annotation", WINDOW_SPAN, 0, 2000)], 0

    def launch(ts, kernel, start, dur):
        nonlocal corr
        corr += 1
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=corr))
        ev.append(_ev("kernel", kernel, start, dur, tid=7, corr=corr, pid=0))

    for base in (0, 1000):
        ev.append(_ev("user_annotation", "bicgstab", base + 10, 950))
        for ts, dur in ((12, 6), (140, 20)):
            if program:
                ev.append(_ev("user_annotation", "sprs.bicgstab.sync", base + ts, dur))
            ev.append(_ev("cuda_runtime", "cudaStreamSynchronize", base + ts + 1, dur - 2))
        for off in (20, 300):
            ev.append(_ev("user_annotation", "spmv", base + off, 10))
            launch(base + off + 2, "dia_spmv_kernel", base + off + 30, 100)
        launch(base + 501, "where", base + 510, 200)
        launch(base + 721, "add", base + 730, 50)
    return Trace(ev)


def _ctx(trace, **kw):
    base = dict(latencies_s=[0.5, 0.5], window_s=2e-3, setup_s=3.0, completed=2, trace=trace,
                counters={"bicgstab_iterations": 4}, host_ms={}, device_kind=H100,
                operator={"n": 1000, "nnz": 4996, "value_bytes": 8})
    base.update(kw)
    return Context(**base)


def test_readers_on_a_hand_made_trace():
    ctx = _ctx(_trace())
    # per set: 950 µs of span, 450 of them busy; 4 iterations in all
    assert reader("bicgstab_gap_us_per_iter")(ctx) == pytest.approx(2 * 500 / 4)
    # per set: 6 µs idle in the first read, 10 in the second
    assert reader("bicgstab_sync_idle_us_per_iter")(ctx) == pytest.approx(2 * 16 / 4)
    # per set: 250 µs of update kernels, the products' 200 left out
    assert reader("bicgstab_update_ms_per_iter")(ctx) == pytest.approx(2 * 250 / 4 / 1e3)
    want = 100 * (stencil_bytes(1000, 4996, 8) / 3.35e12) / 100e-6
    assert reader("poisson_spmv_roofline")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_reports_nothing(name):
    assert reader(name)(_ctx(None)) is None
    assert reader(name)(_ctx(Trace([]), counters={})) is None


def test_a_program_without_the_sync_span_reports_the_rest():
    """A program that opens no ``sprs.bicgstab.sync`` (the port before
    the span) gives no sync reading and raises nothing; the benchmark's
    own spans still read."""
    ctx = _ctx(_trace(program=False))
    assert reader("bicgstab_sync_idle_us_per_iter")(ctx) is None
    for name in READERS:
        if name != "bicgstab_sync_idle_us_per_iter":
            assert reader(name)(ctx) == reader(name)(_ctx(_trace()))


# -- whole runs at a tiny size -------------------------------------------

@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_the_program_agrees_with_the_reference(trace):
    cell = tiny_cell()
    r, log = _run(cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1 and list(r)[-1] == "checks"
    assert set(r["checks"]) == {"resid_err", "x_unchanged", "iterations_off", "resid_ratio",
                                "probe_x_err"}
    assert " route dia " in log
    if trace:
        spans = dict(re.findall(r"(\S+):(\d+)", log.split("spans", 1)[1].splitlines()[0]))
        sets = r["attempted"]
        assert int(spans["bicgstab"]) == sets
        assert int(spans["spmv"]) == sets * (3 * 10 + 2)
        assert int(spans["sprs.bicgstab.sync"]) == sets * (10 + 2)
    else:
        assert {"requests_per_s", "setup_s"} <= set(r["metrics"]) <= {m.name for m in cell.end_to_end}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(seed):
    r, _ = _run(control_cell(tiny_cell()), seed=seed)
    assert not r["correct"], r["checks"]


def _solve_returns(scale):
    """A solve that returns x = scale·b at once, with its true residual."""
    def breaker(real):
        def solve(mat, b, *a, **kw):
            x = b * scale
            return linalg.BiCgStabResult(x, False, kw.get("max_iter", 0),
                                         float(torch.linalg.vector_norm(b - mat(x))))
        return solve
    return breaker


def _product_half(real):
    def prepare(mat):
        fn, prepared = real(mat)

        def half(p, x):
            y = fn(p, x).clone()
            y[y.shape[0] // 2:] = 0
            return y
        return half, prepared
    return prepare


def _solve_altered(real):
    def solve(*a, **kw):
        res = real(*a, **kw)
        res.x[res.x.shape[0] // 3] *= 1.0 + 1e-6
        return res
    return solve


def _solve_stale(real):
    last = {}

    def solve(mat, b, *a, **kw):
        stale = last.get("b", b)
        last["b"] = b
        return real(mat, stale, *a, **kw)
    return solve


def _solve_cut(iters):
    """A solve that runs ``iters(max_iter)`` iterations."""
    def breaker(real):
        def solve(*a, **kw):
            return real(*a, **dict(kw, max_iter=iters(kw["max_iter"])))
        return solve
    return breaker


def _solve_float32(real):
    """The iterations in float32, the final residual norm in float64."""
    def solve(mat, b, *a, **kw):
        res = real(lambda v: mat(v.to(b.dtype)).to(torch.float32), b.to(torch.float32), *a, **kw)
        x = res.x.to(b.dtype)
        return linalg.BiCgStabResult(x, res.converged, res.iterations,
                                     float(torch.linalg.vector_norm(b - mat(x))))
    return solve


def _solve_mutant(line, added):
    """The port's own solver with ``added`` run after its source line
    ``line``: a wrong step inside the loop."""
    def breaker(real):
        mod = importlib.import_module("sprs_tpu_torch.linalg.bicgstab")
        src = inspect.getsource(mod)
        assert src.count(line) == 1
        ns = {"__name__": mod.__name__, "__package__": mod.__package__}
        exec(compile(src.replace(line, line + added), mod.__file__, "exec"), ns)
        return ns["bicgstab"]
    return breaker


ALPHA = "        alpha = torch.where(safe, rho / torch.where(safe, rhat_v, 1.0), 0.0)\n"
OMEGA = "        omega = torch.where(big, _dot(t, sres) / torch.where(big, tt, 1.0), 0.0)\n"

FAULTS = {
    "x zero": (linalg, "bicgstab", _solve_returns(0.0)),
    "x = b": (linalg, "bicgstab", _solve_returns(1.0)),
    "x tiny": (linalg, "bicgstab", _solve_returns(1e-30)),
    "half the rows": (prod, "prepare_spmv", _product_half),
    "answer altered": (linalg, "bicgstab", _solve_altered),
    "stale b": (linalg, "bicgstab", _solve_stale),
    "half the iterations": (linalg, "bicgstab", _solve_cut(lambda k: k // 2)),
    "one iteration": (linalg, "bicgstab", _solve_cut(lambda k: 1)),
    "omega zero": (linalg, "bicgstab", _solve_mutant(OMEGA, "        omega = omega * 0.0\n")),
    "alpha halved": (linalg, "bicgstab", _solve_mutant(ALPHA, "        alpha = alpha * 0.5\n")),
    "float32 iterations": (linalg, "bicgstab", _solve_float32),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_in_the_program_is_not_correct(fault, monkeypatch):
    owner, attr, breaker = FAULTS[fault]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    r, _ = _run(tiny_cell())
    assert r["failed"] == 0  # every request answered: the check's numbers catch the fault
    assert not r["correct"], r["checks"]
