"""One run of one cell: set-up, the measured window, the check, the
metrics, the result line.

Load is a closed loop with one caller: each request is issued when the
one before it has returned, and every request ends in a host
synchronisation.  The window runs requests until ``seconds`` have
passed; it closes when the request running at that moment returns, and
its length is the time to that return, so a rate is all the window's
work over all its time.  A traced run (``trace=True``) records its
window with ``torch.profiler`` and stops after the cell's
``trace_requests`` requests if that comes first, so that the trace
stays small.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import statistics
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from .spec import Cell
from .trace import WINDOW_SPAN, Probe, Trace


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    latencies_s: List[float]
    window_s: float
    setup_s: float
    completed: int
    trace: Optional[Trace]
    counters: Dict[str, float]
    host_ms: Dict[str, List[float]]
    operator: dict
    device_kind: Optional[str]


class Reservoir:
    """A uniform sample of ``k`` of the answers seen, drawn from the seed
    (reservoir sampling), so that any window length works."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, i: int, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((i, item))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (i, item)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(kind, state, probe, seconds, max_requests, sample):
    latencies, ends, failed = [], [], 0
    t0 = time.perf_counter()
    end = t0
    i = 0
    while True:
        ts = time.perf_counter()
        try:
            answer = kind.request(state, i, probe)
        except Exception:  # a request that fails counts, and the run goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
            answer = None
        end = time.perf_counter()
        if answer is not None:
            latencies.append(end - ts)
            ends.append(end - t0)
            sample.offer(i, answer)
        i += 1
        if end - t0 >= seconds or (max_requests and i >= max_requests):
            break
    return latencies, ends, i, failed, end - t0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=sys.stderr) -> dict:
    """Run the cell once and return its result line as a dict (the
    ``checks`` key last).  ``t_start`` is the host clock at the start of
    the process: set-up is counted from there."""
    device = torch.device(device)
    kind = cell.kind()
    probe = Probe(trace, device)
    t_enter = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = kind.setup(cell, device, probe, gen)
    _sync(device)
    t_setup = time.perf_counter()
    kind.warmup(state, probe)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = 0
    if device.type == "cuda":  # memory_peak_bytes is the window's own peak
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    print(f"setup_phases start {t_enter - t_start:.3f} cell {t_setup - t_enter:.3f} "
          f"warmup {setup_s - (t_setup - t_start):.3f} setup_peak_bytes {setup_peak}", file=log)
    probe.counters.clear()
    probe.host_ms.clear()
    sample = Reservoir(int(cell.workload["sample"]), seed)

    prof = None
    with contextlib.ExitStack() as traced:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = traced.enter_context(profile(activities=activities))
            traced.enter_context(torch.profiler.record_function(WINDOW_SPAN))
        latencies, ends, attempted, failed, window_s = _window(
            kind, state, probe, seconds,
            int(cell.workload["trace_requests"]) if trace else 0, sample)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    operator = kind.describe(state)
    reduced = Trace.from_profiler(prof) if prof is not None else None

    kind.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.check(state, sample.items) if sample.items else {}
    correct = (
        failed == 0
        and bool(sample.items)
        and set(checks) == set(cell.limits)
        and all(checks[k] <= cell.limits[k] for k in cell.limits)
    )

    kind_name = torch.cuda.get_device_name(device) if device.type == "cuda" else None
    ctx = Context(latencies, window_s, setup_s, len(latencies), reduced,
                  dict(probe.counters), {k: list(v) for k, v in probe.host_ms.items()},
                  operator, kind_name)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader(cell.bench_dir).read(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": kind_name, "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if reduced is not None:
        w = reduced.window()
        if w is not None:
            device_info["busy_s"] = reduced.busy_us(*w) * 1e-6
            device_info["window_s"] = (w[1] - w[0]) * 1e-6
            result["breakdown"] = {"device_ops": reduced.top_device_ops(*w),
                                   "idle_gaps": reduced.idle_gaps(*w)}
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in checks.items()}

    print(f"cell {cell.name} seed {seed} trace {int(trace)} route {operator.get('route')} "
          f"n {operator.get('n')} nnz {operator.get('nnz')} requests {attempted} "
          f"failed {failed} window_s {window_s:.4f} setup_s {setup_s:.4f} "
          f"sampled {len(sample.items)} memory_peak_bytes {memory_peak}", file=log)
    if latencies:
        print(f"latency_ms median {statistics.median(latencies) * 1e3:.4f} "
              f"max {max(latencies) * 1e3:.4f} counters {dict(probe.counters)}", file=log)
        slices = [0] * (int(window_s // 5) + 1)
        for e in ends:
            slices[min(int(e // 5), len(slices) - 1)] += 1
        print(f"requests_per_5s {slices}", file=log)
    if reduced is not None:
        print(f"trace device_ops {len(reduced.device)} launches {len(reduced.launch)} spans "
              + " ".join(f"{k}:{len(v)}" for k, v in sorted(reduced.spans.items())), file=log)
    return result


def report_checks(result: dict, log=sys.stderr) -> None:
    """Each compared number beside its limit, one line each: the last
    lines a run writes to standard error."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
