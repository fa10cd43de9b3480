"""The readers of the program's own spans (``sprs.*``, opened inside
``sprs_tpu_torch``) on traces made by hand, where the program's spans
nest in the benchmark's, and what the nesting leaves alone."""

import pytest

from harness.loop import Context
from harness.spec import BENCH_DIR, load_module
from harness.trace import WINDOW_SPAN, Trace

H100 = "NVIDIA H100 80GB HBM3"
READERS = ("cg_sync_idle_us_per_iter", "spmv_launch_idle_us_per_call", "index_sum_ms_per_call",
           "compress_device_ms", "route_device_ms")
# the benchmark's readers that read its own spans or the whole window
BENCHMARK_READERS = ("device_idle_share.cg", "device_idle_share.graph",
                     "launches_per_request.cg", "launches_per_request.graph",
                     "cg_gap_us_per_iter", "hpcg_spmv_roofline", "hpcg_perm_spmv_roofline",
                     "kron_spmv_roofline")


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "metric").read


def _ev(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


class _Events:
    """Events of a hand-made trace; ``program=False`` drops the
    program's spans and keeps every other event."""

    def __init__(self, program: bool):
        self.program, self.ev, self.corr = program, [_ev("user_annotation", WINDOW_SPAN, 0, 1000)], 0

    def span(self, name, ts, dur):
        if self.program or not name.startswith("sprs."):
            self.ev.append(_ev("user_annotation", name, ts, dur))

    def launch(self, ts, kernel, start, dur):
        self.corr += 1
        self.ev.append(_ev("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=self.corr))
        self.ev.append(_ev("kernel", kernel, start, dur, tid=7, corr=self.corr, pid=0))

    def sync(self, ts, dur):
        self.span("sprs.cg.sync", ts, dur)
        self.ev.append(_ev("cuda_runtime", "cudaStreamSynchronize", ts + 1, dur - 2))


def _cg_trace(program=True):
    """Two ``cg`` spans [base + 10, base + 460), each of two products in
    ``spmv`` spans, a 20 µs update and three host reads.  Products: a
    100 µs kernel starting 30 µs after its ``spmv`` span, launched inside
    ``sprs.k1`` [off + 1, off + 9) (8 µs idle), the last one inside
    ``sprs.k5`` [off + 1, off + 15) (14 µs idle).  Host reads: [12, 18)
    idle, [140, 160) whose first 10 µs the first product still runs,
    [400, 410) idle: 26 µs idle a set."""
    e = _Events(program)
    for base in (0, 500):
        e.span("cg", base + 10, 450)
        e.sync(base + 12, 6)
        for off in (20, 200):
            kernel, dur = ("k5", 14) if (base, off) == (500, 200) else ("k1", 8)
            e.span("spmv", base + off, 20)
            e.span(f"sprs.{kernel}", base + off + 1, dur)
            e.launch(base + off + 2, kernel, base + off + 30, 100)
        e.sync(base + 140, 20)
        e.ev.append(_ev("cpu_op", "aten::add", base + 350, 5))
        e.launch(base + 351, "add", base + 360, 20)
        e.sync(base + 400, 10)
    return Trace(e.ev)


def _kron_trace(program=True):
    """Two PageRank products and one build.  A product: a ``spmv`` span
    [off, off + 30) with a 10 µs gather, then ``sprs.index_sum`` [off + 5,
    off + 25) launching a 30 µs sort and a 120 µs accumulate.  The
    build: ``compress`` [600, 700) holding ``sprs.coo_to_csmat`` [601,
    699), which launches a 60 µs key sort and holds a ``sprs.index_sum``
    [610, 620) of one 40 µs sum; ``route`` [700, 710) holding
    ``sprs.prepare_spmv`` [702, 708) with one 20 µs count."""
    e = _Events(program)
    e.span("pagerank", 0, 600)
    for off, start in ((10, 40), (300, 330)):
        e.span("spmv", off, 30)
        e.launch(off + 2, "gather", start, 10)
        e.span("sprs.index_sum", off + 5, 20)
        e.launch(off + 6, "radix_sort", start + 10, 30)
        e.launch(off + 10, "indexing_backward_kernel", start + 40, 120)
    e.span("build", 600, 400)
    e.span("compress", 600, 100)
    e.span("sprs.coo_to_csmat", 601, 98)
    e.launch(605, "key_sort", 700, 60)
    e.span("sprs.index_sum", 610, 10)
    e.launch(612, "indexing_backward_kernel", 760, 40)
    e.span("route", 700, 10)
    e.span("sprs.prepare_spmv", 702, 6)
    e.launch(703, "unique_count", 800, 20)
    return Trace(e.ev)


def _ctx(trace, **kw):
    base = dict(latencies_s=[0.5, 0.5], window_s=1e-3, setup_s=3.0, completed=2, trace=trace,
                counters={"cg_iterations": 4}, host_ms={}, device_kind=H100,
                operator={"n": 1000, "nnz": 27000, "value_bytes": 8})
    base.update(kw)
    return Context(**base)


def test_cg_readers():
    t = _cg_trace()
    assert t.span_idle_us("sprs.cg.sync") == (6, pytest.approx(52))
    assert reader("cg_sync_idle_us_per_iter")(_ctx(t)) == pytest.approx(52 / 4)
    assert reader("spmv_launch_idle_us_per_call")(_ctx(t)) == pytest.approx((3 * 8 + 14) / 4)
    # the split the readers make of the benchmark's gap: sync, launch, rest
    gap = reader("cg_gap_us_per_iter")(_ctx(t))
    assert gap == pytest.approx(2 * (450 - 220) / 4)
    assert 52 / 4 + (3 * 8 + 14) / 4 <= gap


def test_kron_readers():
    t = _kron_trace()
    ctx = _ctx(t, counters={})
    assert reader("index_sum_ms_per_call")(ctx) == pytest.approx((150 + 150 + 40) / 3 / 1e3)
    assert reader("compress_device_ms")(ctx) == pytest.approx(0.1)
    assert reader("route_device_ms")(ctx) == pytest.approx(0.02)
    # the index sum is inside the benchmark's spmv span: 20 of it per request are at most it
    calls, spmv_us, _ = t.span_device("spmv")
    assert calls == 2 and 2 * 150 <= spmv_us


@pytest.mark.parametrize("name", READERS)
def test_a_program_span_reader_with_nothing_to_read_reports_nothing(name):
    assert reader(name)(_ctx(None)) is None
    assert reader(name)(_ctx(Trace([]), counters={})) is None
    for trace in (_cg_trace(program=False), _kron_trace(program=False)):
        assert reader(name)(_ctx(trace)) is None


@pytest.mark.parametrize("name", BENCHMARK_READERS)
@pytest.mark.parametrize("make", [_cg_trace, _kron_trace], ids=["cg", "kron"])
def test_program_spans_leave_the_benchmark_readers_alone(name, make):
    """The same trace with and without the program's spans nested in the
    benchmark's gives the benchmark's readers the same numbers."""
    with_spans, without = (reader(name)(_ctx(make(program=p))) for p in (True, False))
    assert with_spans == without
