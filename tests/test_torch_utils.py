"""The port's utilities (``sprs_tpu_torch.utils``: fixtures, visu,
profile), the API names the earlier slices left out, and the examples
that ride on them, against the JAX package.

Exactly equal: the fixtures, the pattern strings, arrays and images, the
byte formulas, ``roofline_report``'s record for the same inputs,
``ell_to_csmat`` / ``EllMat.nnz``, ``prune_channel``, the ``compress_coo``
export, ``RoundSchedule.n_rounds`` / ``Bu`` / ``Bf`` and
``MfPlan.agg_table_elems``, and the examples' printed patterns and plan
sizes.  The timers run on the CPU (perf_counter; CUDA events on a card)
and ``audit_spmv`` takes each of its three branches there.
"""

import sys

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as tt
from sprs_tpu.formats import ell as j_ell
from sprs_tpu.formats import util as j_util
from sprs_tpu.utils import fixtures as j_fix
from sprs_tpu.utils import profile as j_prof
from sprs_tpu.utils import visu as j_visu
from sprs_tpu_torch.formats import util as t_util
from sprs_tpu_torch.linalg import ldl_batched as t_lb
from sprs_tpu.linalg import ldl_batched as j_lb
from sprs_tpu_torch.utils import fixtures as t_fix
from sprs_tpu_torch.utils import profile as t_prof
from sprs_tpu_torch.utils import visu as t_visu
from tests.test_torch_ldl_batched import plans


@pytest.mark.parametrize("name", ["dense_a", "dense_b", "dense_rect", "dense_spd", "all_fixtures"])
def test_fixtures_equal(name):
    got, want = getattr(t_fix, name)(), getattr(j_fix, name)()
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)
    assert t_fix.dense_spd(13, seed=3).tobytes() == j_fix.dense_spd(13, seed=3).tobytes()


@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_sparse_of(storage):
    got = t_fix.sparse_of(t_fix.dense_rect(), storage, device="cpu")
    want = j_fix.sparse_of(j_fix.dense_rect(), storage)
    assert got.storage == storage
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


VISU_CASES = {
    "a": lambda: t_fix.dense_a(),
    "rect": lambda: t_fix.dense_rect(),
    "eye": lambda: np.eye(3),
    "random": lambda: np.random.default_rng(5).standard_normal((9, 14))
    * (np.random.default_rng(6).random((9, 14)) < 0.3),
}


@pytest.mark.parametrize("case", list(VISU_CASES))
@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_visu_equal(case, storage):
    d = VISU_CASES[case]()
    jm = st.from_dense(d, storage=storage)
    pm = tt.from_dense(d, storage=storage, device="cpu")
    assert t_visu.nnz_pattern_str(pm) == j_visu.nnz_pattern_str(jm)
    assert t_visu.nnz_pattern_str(pm, nnz_char="#", zero_char=".") == j_visu.nnz_pattern_str(
        jm, nnz_char="#", zero_char=".")
    np.testing.assert_array_equal(t_visu.nnz_pattern(pm), j_visu.nnz_pattern(jm))
    img = t_visu.nnz_image(pm)
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(img, j_visu.nnz_image(jm))


def test_visu_keeps_stored_zeros_and_padding_out():
    pm = tt.from_dense(np.eye(4), device="cpu").with_cap(9).with_data(
        torch.tensor([1.0, 0.0, 2.0, 3.0, 0, 0, 0, 0, 0], dtype=torch.float64))
    assert tt.utils.nnz_pattern_str(pm).splitlines()[1] == "| x  |"  # a stored zero shows


BYTE_ARGS = [(0, 1), (5, 3), (1000, 77), (2**20, 2**12)]


@pytest.mark.parametrize("a,b", BYTE_ARGS)
def test_byte_formulas_equal(a, b):
    for vb in (2, 4, 8):
        assert t_prof.csr_spmv_bytes(a, b, vb) == j_prof.csr_spmv_bytes(a, b, vb)
        assert t_prof.csr_spmv_bytes(a, b, vb, 8) == j_prof.csr_spmv_bytes(a, b, vb, 8)
        assert t_prof.ell_spmv_bytes(a, b, a + b, vb) == j_prof.ell_spmv_bytes(a, b, a + b, vb)
        assert t_prof.dia_spmv_bytes(b, a, a + 1, vb) == j_prof.dia_spmv_bytes(b, a, a + 1, vb)
        assert t_prof.bsr_spmm_bytes(a, 8, b, 3, vb) == j_prof.bsr_spmm_bytes(a, 8, b, 3, vb)
    assert t_prof.dia_spmv_bytes(5, a, b) == j_prof.dia_spmv_bytes(5, a, b)


@pytest.mark.parametrize("flops", [0, 12345])
def test_roofline_report_equal(flops):
    got = t_prof.roofline_report("k", 1.5e-4, 7_000_000, flops=flops, peak_gbps=512.25, device="cpu")
    want = j_prof.roofline_report("k", 1.5e-4, 7_000_000, flops=flops, peak_gbps=512.25)
    assert list(got) == list(want)
    assert got == want  # both on the CPU: "backend" is "cpu" in each


def test_timers_run_on_the_cpu(tmp_path):
    x = torch.ones(64, dtype=torch.float64)
    calls = []

    def step(v):
        calls.append(1)
        return v * 0.5

    assert t_prof.chain_time(step, x, iters=7) > 0 and len(calls) == 8
    assert t_prof.chain_time_best(step, x, iters=3, rounds=2) > 0 and len(calls) == 15
    assert t_prof.fori_chain_time(lambda m, v: m * v, 0.5, x, inner=4, rounds=2) > 0
    assert t_prof.fetch_scalar((torch.tensor([3.0, 1.0]), x)) == 3.0
    assert t_prof.fetch_scalar({"a": [torch.tensor(2.5)]}) == 2.5
    assert t_prof.measure_peak_bandwidth(1 << 16, 3, device="cpu") > 0
    with t_prof.trace(str(tmp_path)) as log_dir:
        step(x)
    assert (tmp_path / "trace.json").exists() and log_dir == str(tmp_path)


@pytest.mark.parametrize("kind,label", [("band", "torch_dia_spmv"), ("ell", "torch_ell_spmv"),
                                        ("csr", "torch_csr_spmv")])
def test_audit_spmv_branches_on_the_cpu(kind, label, monkeypatch):
    monkeypatch.setattr(t_prof, "measure_peak_bandwidth", lambda **kw: 100.0)
    n = 64
    if kind == "band":
        m = tt.utils.grid_laplacian((8, 8), device="cpu")
    else:
        rng = np.random.default_rng(1)
        d = np.zeros((n, n))
        width = 6 if kind == "ell" else 1
        for i in range(n):
            d[i, rng.choice(n, width, replace=False)] = 0.1
        if kind == "csr":
            d[0, : n // 2] = 0.1  # one long row: ELL would pad every row to it
        m = tt.from_dense(d, device="cpu")
    rep = tt.utils.audit_spmv(m, iters=3)
    assert rep["kernel"] == label and rep["peak_GBps"] == 100.0 and rep["backend"] == "cpu"
    assert list(rep) == ["kernel", "seconds", "achieved_GBps", "peak_GBps", "roofline_fraction",
                         "gflops", "backend"]


# -- the API names earlier slices left out -----------------------------------


@pytest.mark.parametrize("cap", [None, 3, 40])
def test_ell_to_csmat_and_nnz(cap):
    d = VISU_CASES["random"]()
    d[2, 4] = 0.0
    jm, pm = st.from_dense(d), tt.from_dense(d, device="cpu")
    je, pe = jm.to_ell(), pm.to_ell()
    assert pe.nnz == int(je.nnz)
    want = j_ell.ell_to_csmat(je, cap=cap)
    got = tt.formats.ell_to_csmat(pe, cap=cap)
    assert got.shape == want.shape and got.storage == want.storage
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_prune_channel_and_compress_coo_export():
    v = np.arange(1.0, 9.0)
    for nnz, pad in ((0, 0), (3, 0), (5, -1.5), (8, 7)):
        got = t_util.prune_channel(torch.from_numpy(v), nnz, pad_value=pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_util.prune_channel(v, nnz, pad_value=pad)))
    assert tt.formats.compress_coo is t_util.compress_coo
    assert "compress_coo" in dir(st.formats)


@pytest.mark.parametrize("kind", ["super", "mf"])
def test_schedule_and_plan_diagnostics(kind):
    kw = {"max_front_cols": 24} if kind == "mf" else {}
    jplan, plan, _, _ = plans("grid9x13", "camd", kind, **kw)
    sched, jsched = t_lb.build_round_schedule(plan), j_lb.build_round_schedule(jplan)
    assert (sched.n_rounds, sched.Bu, sched.Bf) == (jsched.n_rounds, jsched.Bu, jsched.Bf)
    if kind == "mf":
        assert plan.agg_table_elems == jplan.agg_table_elems > 0


# -- the examples ------------------------------------------------------------


def test_heat_and_fill_examples_print_the_jax_patterns(capsys):
    from sprs_tpu_torch.examples import fill_in_reduction, heat

    heat.main(["6", "--device", "cpu"])
    out = capsys.readouterr().out
    want = st.utils.nnz_pattern_str(st.utils.grid_laplacian((6, 6), dtype=np.float64))
    assert "Laplacian nonzero pattern:\n" + want + "\n" in out
    fill_in_reduction.main(["24", "--device", "cpu"])
    out = capsys.readouterr().out
    jm = st.from_dense(fill_in_reduction.random_spd(24))
    rcm = st.linalg.reverse_cuthill_mckee(jm)
    permuted = st.ops.transform_mat_papt(jm, rcm.permutation())
    want = (st.utils.nnz_pattern_str(jm) + "\n\n" + st.utils.nnz_pattern_str(permuted))
    assert "pattern before / after RCM:\n" + want + "\n" in out


def _printed(out, prefix):
    return next(line for line in out.splitlines() if line.startswith(prefix))


def test_batched_small_systems_example(capsys):
    from examples.batched_small_systems import main as jax_main
    from sprs_tpu_torch.examples.batched_small_systems import main

    jax_main()
    want = float(_printed(capsys.readouterr().out, "max relative residual").split(":")[1])
    out = main(["--device", "cpu"])
    got = float(_printed(capsys.readouterr().out, "max relative residual").split(":")[1])
    assert want < 1e-12 and got < 1e-12
    a = tt.utils.dirichlet_laplacian((12, 12), device="cpu").to_dense().numpy()
    scales = np.random.default_rng(0).random(8) + 0.5
    for i in range(8):
        ref = np.linalg.solve(scales[i] * a, out["b"][i].numpy())
        np.testing.assert_allclose(out["x"][i].numpy(), ref, rtol=1e-10, atol=1e-12)


def test_supernodal_refactorization_example(capsys, monkeypatch):
    from examples.supernodal_refactorization import main as jax_main
    from sprs_tpu_torch.examples.supernodal_refactorization import main

    monkeypatch.setattr(sys, "argv", ["supernodal_refactorization", "8", "2"])
    jax_main()
    jout = capsys.readouterr().out
    out = main(["8", "2", "--device", "cpu"])
    pout = capsys.readouterr().out
    strip = lambda s: s.split(" (")[0]  # noqa: E731 — drop the host milliseconds
    # n, l_nnz and the supernode count equal the JAX example's
    assert strip(_printed(pout, "symbolic:")) == strip(_printed(jout, "symbolic:"))
    assert out["n"] == 64 and out["supernodes"] > 1
    for text in (jout, pout):
        assert float(_printed(text, "relative residual").split(":")[1]) < 1e-10


@pytest.mark.gpu
def test_timers_and_audit_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sprs_tpu_torch.ops.cuda.dia_spmv import dia_spmv_kernel

    m = tt.utils.grid_laplacian((64, 64), torch.float32, device="cuda")
    before = dia_spmv_kernel.launches
    rep = tt.utils.audit_spmv(m, iters=5)
    assert rep["kernel"] == "cuda_dia_spmv" and rep["backend"] == "cuda"
    assert dia_spmv_kernel.launches - before == 6
    assert 0 < rep["roofline_fraction"] and t_prof.measure_peak_bandwidth(1 << 24, 5) > 0
