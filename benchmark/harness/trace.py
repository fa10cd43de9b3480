"""Spans, counters and the reduction of a ``torch.profiler`` trace.

The benchmark's own code marks its calls into the program with
:meth:`Probe.span` (a ``record_function`` range, in the traced run
only) and :meth:`Probe.timed` (a host-clock span that ends in
``synchronize``, in the traced run only), and counts work with
:meth:`Probe.count`.  The traced run exports the profiler's Chrome trace
into the run's temporary directory, and :class:`Trace` reduces it to
what the metric readers take: device intervals, the device time of the
kernels launched inside each named span, idle time, top device ops and
idle gaps labelled by what the host was doing.  The file is deleted
once read.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


class Probe:
    """What a request's code uses to mark its calls.  With
    ``tracing=False`` every mark is a no-op, so the timed run carries
    none of them."""

    def __init__(self, tracing: bool, device: torch.device):
        self.tracing = tracing
        self.device = device
        self.counters: Dict[str, float] = collections.Counter()
        self.host_ms: Dict[str, List[float]] = collections.defaultdict(list)

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def timed(self, name: str):
        """A span of ``name`` whose host-clock length, from a synchronise
        to a synchronise, is kept in ``host_ms[name]`` (traced run only)."""
        if not self.tracing:
            yield
            return
        with torch.profiler.record_function(name):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.host_ms[name].append((time.perf_counter() - t0) * 1e3)

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] += n


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _clip_len(merged: List[Tuple[float, float]], a: float, b: float) -> float:
    """Length of the part of the merged intervals inside [a, b]."""
    i = max(bisect.bisect_right(merged, (a, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        if hi > lo:
            total += hi - lo
        i += 1
    return total


class Trace:
    """A Chrome trace of the traced window, reduced.  Times in µs on the
    trace's clock, which holds host and device events alike."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch: Dict[int, Tuple[int, float]] = {}
        self.host: List[Tuple[float, float, str, str, int]] = []
        self.spans: Dict[str, List[Tuple[int, float, float]]] = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            if cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (e.get("tid"), ts)
            if cat in HOST_CATS:
                self.host.append((ts, ts + dur, e.get("name", ""), cat, e.get("tid")))
            if cat == "user_annotation":
                self.spans[e.get("name", "")].append((e.get("tid"), ts, ts + dur))
        self.device.sort()
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]
        self.merged = _union([(a, b) for a, b, _, _ in self.device])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- the window -----------------------------------------------------
    def window(self) -> Optional[Tuple[float, float]]:
        spans = self.spans.get(WINDOW_SPAN)
        if not spans:
            return None
        _, a, b = spans[0]
        return a, b

    def busy_us(self, a: float, b: float) -> float:
        return _clip_len(self.merged, a, b)

    def device_ops_in(self, a: float, b: float) -> List[Tuple[float, float, str, Optional[int]]]:
        return [d for d in self.device if a <= d[0] < b]

    # -- spans ----------------------------------------------------------
    def span_device(self, name: str) -> Tuple[int, float, int]:
        """(spans of ``name``, µs of device ops launched inside them, those
        ops).  An op belongs to a span when the host call that launched it
        (by the trace's correlation id) ran inside the span, on its
        thread."""
        spans = self.spans.get(name, [])
        if not spans:
            return 0, 0.0, 0
        by_tid: Dict[int, List[Tuple[float, float]]] = collections.defaultdict(list)
        for tid, a, b in spans:
            by_tid[tid].append((a, b))
        for v in by_tid.values():
            v.sort()
        total, ops = 0.0, 0
        for a, b, _, corr in self.device:
            hit = self.launch.get(corr)
            if hit is None:
                continue
            tid, ts = hit
            ivs = by_tid.get(tid)
            if not ivs:
                continue
            i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= ts <= ivs[i][1]:
                total += b - a
                ops += 1
        return len(spans), total, ops

    def span_idle_us(self, name: str) -> Tuple[int, float]:
        """(spans of ``name``, µs inside them in which no device op ran)."""
        spans = self.spans.get(name, [])
        return len(spans), sum((b - a) - self.busy_us(a, b) for _, a, b in spans)

    # -- the breakdown --------------------------------------------------
    def top_device_ops(self, a: float, b: float, k: int = 10) -> List[list]:
        total: Dict[str, float] = collections.Counter()
        for s, e, name, _ in self.device_ops_in(a, b):
            total[name] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def _host_label(self, t: float) -> str:
        """'<innermost benchmark span>/<innermost host event>' at time t."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        inner, span = None, None
        for j in range(i, max(i - 400, -1), -1):
            s, e, name, cat, _ = self.host[j]
            if s <= t <= e:
                if inner is None:
                    inner = name
                if cat == "user_annotation" and name != WINDOW_SPAN:
                    span = name
                    break
        parts = [p for p in (span, inner) if p]
        return "/".join(dict.fromkeys(parts)) or "host"

    def idle_gaps(self, a: float, b: float, k: int = 10) -> List[list]:
        """Idle time inside [a, b], summed by what the host was doing at
        the middle of each gap; the k largest sums, in seconds."""
        merged = [(max(s, a), min(e, b)) for s, e in self.merged if e > a and s < b]
        edges = [a] + [x for iv in merged for x in iv] + [b]
        total: Dict[str, float] = collections.Counter()
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi > lo:
                total[self._host_label((lo + hi) / 2)] += (hi - lo) * 1e-6
        return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_percent(trace: Optional[Trace]) -> Optional[float]:
    """100 · (1 - union of the device ops' intervals / the traced
    window), or None where nothing ran on the device."""
    w = trace.window() if trace is not None else None
    if w is None or not trace.device:
        return None
    a, b = w
    return 100.0 * (1.0 - trace.busy_us(a, b) / (b - a))


def ops_per_request(trace: Optional[Trace], completed: int) -> Optional[float]:
    """Device ops (kernels, copies, sets) started in the traced window
    per request completed in it."""
    w = trace.window() if trace is not None else None
    if w is None or not trace.device or not completed:
        return None
    return len(trace.device_ops_in(*w)) / completed
