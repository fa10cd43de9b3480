"""The yardsticks: the roofline byte formulas, and the reduction of a
profiler trace to the per-layer metrics, on a trace made by hand."""

import pytest

from harness.loop import Context
from harness.peaks import peak
from harness.roofline import csr_bytes, share_percent, stencil_bytes
from harness.spec import BENCH_DIR, load_module
from harness.trace import WINDOW_SPAN, Trace

H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "metric").read


def test_hpcg_bytes_count_values_and_two_vectors():
    n, nnz = 256 ** 3, 766 ** 3
    assert stencil_bytes(n, nnz, 8) == 449_455_096 * 8 + 2 * 16_777_216 * 8 == 3_864_076_224
    assert stencil_bytes(n, nnz, 8) / 3.35e12 == pytest.approx(1.1535e-3, rel=1e-3)


def test_csr_bytes_count_indices_and_row_pointers_once():
    n, nnz = 256 ** 3, 766 ** 3
    assert csr_bytes(n, nnz, 8) == nnz * 12 + (n + 1) * 4 + 2 * n * 8 == 5_729_005_476
    assert csr_bytes(1 << 23, 258_669_824, 4) == 258_669_824 * 8 + ((1 << 23) + 1) * 4 + 2 * (1 << 23) * 4


def test_peak_table():
    assert peak(H100, "hbm_bytes_per_s") == 3.35e12
    assert peak("some other card", "hbm_bytes_per_s") is None


def _ev(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A window [0, 1000) µs with two cg spans; in each, two spmv spans
    that launch one 100 µs kernel each, and a 20 µs update kernel."""
    ev = [_ev("user_annotation", WINDOW_SPAN, 0, 1000)]
    corr = 0
    for base in (0, 500):
        ev.append(_ev("user_annotation", "cg", base + 10, 450))
        for k, off in enumerate((20, 200)):
            corr += 1
            ev.append(_ev("user_annotation", "spmv", base + off, 10))
            ev.append(_ev("cuda_runtime", "cudaLaunchKernel", base + off + 2, 3, corr=corr))
            ev.append(_ev("kernel", "k1", base + off + 30, 100, tid=7, corr=corr, pid=0))
        corr += 1
        ev.append(_ev("cpu_op", "aten::add", base + 350, 5))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", base + 351, 3, corr=corr))
        ev.append(_ev("kernel", "add", base + 360, 20, tid=7, corr=corr, pid=0))
    return Trace(ev)


def _ctx(trace, **kw):
    base = dict(latencies_s=[0.5, 0.5], window_s=1e-3, setup_s=3.0, completed=2, trace=trace,
                counters={"cg_iterations": 4}, host_ms={}, device_kind=H100,
                operator={"n": 1000, "nnz": 27000, "value_bytes": 8})
    base.update(kw)
    return Context(**base)


def test_trace_reduction():
    t = _trace()
    assert t.window() == (0, 1000)
    assert t.busy_us(0, 1000) == pytest.approx(440)
    assert t.span_device("spmv") == (4, pytest.approx(400), 4)
    spans, idle = t.span_idle_us("cg")
    assert spans == 2 and idle == pytest.approx(2 * (450 - 220))
    ops = dict(t.top_device_ops(0, 1000))
    assert ops["k1"] == pytest.approx(400e-6) and ops["add"] == pytest.approx(40e-6)
    assert sum(v for _, v in t.idle_gaps(0, 1000)) == pytest.approx(560e-6)


def test_trace_readers():
    ctx = _ctx(_trace())
    for family in ("cg", "graph"):
        assert reader(f"device_idle_share.{family}")(ctx) == pytest.approx(56.0)
        assert reader(f"launches_per_request.{family}")(ctx) == pytest.approx(3.0)
    assert reader("cg_gap_us_per_iter")(ctx) == pytest.approx(460 / 4)
    want = 100 * (stencil_bytes(1000, 27000, 8) / 3.35e12) / 100e-6
    assert reader("hpcg_spmv_roofline")(ctx) == pytest.approx(want)
    want = 100 * (csr_bytes(1000, 27000, 8) / 3.35e12) / 100e-6
    assert reader("hpcg_perm_spmv_roofline")(ctx) == pytest.approx(want)
    assert reader("kron_spmv_roofline")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_share.cg", "device_idle_share.graph",
                                  "launches_per_request.cg", "launches_per_request.graph",
                                  "cg_gap_us_per_iter", "hpcg_spmv_roofline",
                                  "hpcg_perm_spmv_roofline", "kron_spmv_roofline",
                                  "compress_ms", "route_ms"])
def test_a_reader_with_nothing_to_read_reports_nothing(name):
    assert reader(name)(_ctx(None)) is None
    assert reader(name)(_ctx(Trace([]), counters={})) is None


def test_a_roofline_on_a_card_without_peaks_reports_nothing():
    assert share_percent(_ctx(_trace(), device_kind="cpu"), 10 ** 6) is None


def test_host_clock_readers():
    ctx = _ctx(None, latencies_s=[i * 1e-3 for i in range(1, 101)], window_s=2.0, completed=100,
               host_ms={"compress": [100.0, 110.0], "route": [10.0]})
    assert reader("requests_per_s")(ctx) == 50.0 and reader("graph_requests_per_s")(ctx) == 50.0
    assert reader("request_ms_p95")(ctx) == pytest.approx(95.95)
    assert reader("setup_s")(ctx) == 3.0
    assert reader("compress_ms")(ctx) == 105.0 and reader("route_ms")(ctx) == 10.0
