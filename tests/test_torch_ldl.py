"""LDLᵀ of the PyTorch port against the JAX package's
``sprs_tpu.linalg.ldl``: the reference's golden fixture, the symbolic
arrays for every fill-in reduction (native and numpy symbolic), the host
numeric, the row-scan device numeric (its NaN-poisoned zero pivot
included), the levels and flat solves on a vector and a block, and the
panel backends and the panel solve against the host numeric.

Exactly equal: every symbolic array and schedule, and the host numeric
(numpy against numpy).  The device numeric and the solves agree to
rtol 1e-12 (other summation orders).  Inputs: a 12² grid Laplacian and a
40-row random SPD matrix, f64, from seeds with numpy.
"""

import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu import native as j_native
from sprs_tpu.linalg import Ldl as JLdl
from sprs_tpu.linalg import ldl as j_ldl
from sprs_tpu_torch import native
from sprs_tpu_torch.errors import CapacityError, SingularMatrixError
from sprs_tpu_torch.formats.csmat import csc
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import FILL_ND, Ldl, LdlNumeric
from sprs_tpu_torch.linalg import ldl as t_ldl

RTOL = 1e-12
FILLS = ["none", "rcm", "camd", "nd"]

# the reference's test_mat1 (sprs-ldl/src/lib.rs:634-686), as in
# tests/test_ldl_golden.py: CSC 10x10, its L below the diagonal and D
INDPTR = [0, 2, 5, 6, 7, 13, 14, 17, 20, 24, 28]
INDICES = [0, 8, 1, 4, 9, 2, 3, 1, 4, 6, 7, 8, 9, 5, 4, 6, 9, 4, 7, 8, 0,
           4, 7, 8, 1, 4, 6, 9]
DATA = [1.7, 0.13, 1.0, 0.02, 0.01, 1.5, 1.1, 0.02, 2.6, 0.16, 0.09, 0.52,
        0.53, 1.2, 0.16, 1.3, 0.56, 0.09, 1.6, 0.11, 0.13, 0.52, 0.11, 1.4,
        0.01, 0.53, 0.56, 3.1]
VEC = [0.287, 0.22, 0.45, 0.44, 2.486, 0.72, 1.55, 1.424, 1.621, 3.759]
EXP_LP = [0, 1, 3, 3, 3, 7, 7, 10, 12, 13, 13]
EXP_LI = [8, 4, 9, 6, 7, 8, 9, 7, 8, 9, 8, 9, 9]
EXP_LX = [0.076470588235294124, 0.02, 0.01, 0.061547930450838589,
          0.034620710878596701, 0.20003077396522542, 0.20380058470533929,
          -0.0042935346524025902, -0.024807089102770519,
          0.40878266366119237, 0.05752526570865537,
          -0.010068305077340346, -0.071852278207562709]
EXP_D = [1.7, 1.0, 1.5, 1.1000000000000001, 2.5996000000000001, 1.2,
         1.290152331127866, 1.5968603527854308, 1.2799646117414738,
         2.7695677698030283]
EXP_X = [0.099999999999999992, 0.19999999999999998, 0.29999999999999999,
         0.39999999999999997, 0.5, 0.59999999999999998,
         0.70000000000000007, 0.79999999999999993, 0.90000000000000002,
         0.99999999999999989]


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native library.  Its loader compiles into the
    package directory without a lock, so a process whose first load met
    another test process mid-build has given up on it; such a process
    gets a private build here."""
    lib = j_native.get_lib()
    if lib is None:
        out = Path(tempfile.mkdtemp()) / "libsprs_host.so"
        subprocess.run(["g++", *native.GXX_FLAGS, j_native._SRC, "-o", str(out)], check=True,
                       capture_output=True, timeout=240)
        lib = ctypes.CDLL(str(out))
        j_native._bind(lib)
    monkeypatch.setattr(j_native, "_lib", lib)
    return lib


def port_of(m):
    return from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), storage=m.storage, device="cpu")


def random_spd(n=40, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n))
    d[rng.random((n, n)) > density] = 0.0
    d = (d + d.T) / 2
    d += np.eye(n) * (np.abs(d).sum(axis=1).max() + 1.0)
    return st.from_dense(d)


MATS = {"grid12": lambda: st.utils.dirichlet_laplacian((12, 12)), "random40": random_spd}


def golden_offdiag(l_mat):
    """(indptr, indices, data) of L's strict lower part per column."""
    indptr = l_mat.indptr.numpy()
    indices = l_mat.indices.numpy()
    data = l_mat.data.numpy()
    lp, li, lx = [0], [], []
    for c in range(10):
        for p in range(indptr[c], indptr[c + 1]):
            if indices[p] != c:
                li.append(int(indices[p]))
                lx.append(float(data[p]))
        lp.append(len(li))
    return lp, li, lx


@pytest.mark.parametrize("backend", ["host", "device"])
def test_golden_factor(backend):
    num = Ldl().check_symmetry(False).numeric(csc((10, 10), INDPTR, INDICES, DATA, device="cpu"),
                                              backend=backend)
    lp, li, lx = golden_offdiag(num.l())
    assert (lp, li) == (EXP_LP, EXP_LI)
    np.testing.assert_allclose(lx, EXP_LX, rtol=1e-13)
    np.testing.assert_allclose(num.d_diag().numpy(), EXP_D, rtol=1e-13)
    np.testing.assert_allclose(num.solve(np.asarray(VEC)).numpy(), EXP_X, rtol=1e-12)


def test_golden_update_same_pattern():
    num = Ldl().check_symmetry(False).numeric(csc((10, 10), INDPTR, INDICES, DATA, device="cpu"))
    num2 = num.update(csc((10, 10), INDPTR, INDICES, 2 * np.asarray(DATA), device="cpu"))
    np.testing.assert_allclose(golden_offdiag(num2.l())[2], EXP_LX, rtol=1e-12)
    np.testing.assert_allclose(num2.d_diag().numpy(), 2 * np.asarray(EXP_D), rtol=1e-12)


SYM_FIELDS = ("parent", "l_indptr", "l_indices", "rp_indptr", "rp_cols", "rp_slots", "a_pos",
              "a_col", "a_live", "lcsr_indptr", "lcsr_indices", "lcsr_gather", "row_pattern",
              "insert_pos")


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("name", list(MATS))
def test_symbolic_and_host_numeric_equal(name, fill, path, monkeypatch, jax_native):
    m = MATS[name]()
    if path == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
    want = JLdl().fill_in_reduction(fill).symbolic(m)
    got = Ldl().fill_in_reduction(fill).symbolic(port_of(m))
    for f in SYM_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.n, got.nnz, got.wc, got.wl) == (want.n, want.nnz, want.wc, want.wl)
    if want.perm is None:
        assert got.perm is None
    else:
        np.testing.assert_array_equal(got.perm.perm.numpy(), np.asarray(want.perm.perm))
    for s in ("sched_lower", "sched_upper"):
        for f in ("order", "offsets"):
            np.testing.assert_array_equal(getattr(getattr(got, s), f),
                                          getattr(getattr(want, s), f))
    for a, b in zip(got.flat_scheds(), want.flat_scheds()):
        for f in ("e_slot", "e_col", "e_row", "f_row", "f_dslot"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    j_num, num = want.factor(m), got.factor(port_of(m))
    np.testing.assert_array_equal(num.l_data.numpy(), np.asarray(j_num.l_data))
    np.testing.assert_array_equal(num.d.numpy(), np.asarray(j_num.d))
    for part in ("l", "l_csr", "lt"):
        g, w = getattr(num, part)(), getattr(j_num, part)()
        assert g.storage == w.storage
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))


@pytest.mark.parametrize("name", list(MATS))
def test_device_numeric_matches_jax(name):
    m = MATS[name]()
    j_sym = JLdl().fill_in_reduction("rcm").symbolic(m)
    jl, jd = j_ldl._numeric_device(j_sym, m.to_csr().data)
    num = Ldl().fill_in_reduction("rcm").numeric(port_of(m), backend="device")
    np.testing.assert_allclose(num.l_data.numpy(), np.asarray(jl), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(num.d.numpy(), np.asarray(jd), rtol=RTOL)


def test_zero_pivot():
    """The host numeric raises; the device numeric NaN-poisons as the
    JAX package's does."""
    d = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 2.0]])
    m = st.from_dense(d)
    with pytest.raises(SingularMatrixError, match="zero pivot"):
        Ldl().numeric(port_of(m))
    jl, jd = j_ldl._numeric_device(JLdl().symbolic(m), m.data)
    num = Ldl().numeric(port_of(m), backend="device")
    for got, want in ((num.l_data, jl), (num.d, jd)):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    assert np.isnan(num.d.numpy()).any()


@pytest.mark.parametrize("k", [0, 3], ids=["vector", "block"])
@pytest.mark.parametrize("method", ["levels", "flat"])
@pytest.mark.parametrize("fill", ["rcm", "nd"])
@pytest.mark.parametrize("name", list(MATS))
def test_solve_matches_jax(name, fill, method, k):
    m = MATS[name]()
    n = m.shape[0]
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n) if k == 0 else rng.standard_normal((n, k))
    want = np.asarray(JLdl().fill_in_reduction(fill).numeric(m).solve(b, method=method))
    num = Ldl().fill_in_reduction(fill).numeric(port_of(m))
    assert num.solve_method(method) == method
    assert num.solve_method("auto") == "levels"  # n·max row nnz is far below 2²⁴
    got = num.solve(torch.from_numpy(b), method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    if k:
        for j in range(k):
            col = num.solve(torch.from_numpy(b[:, j].copy()), method=method)
            np.testing.assert_allclose(got[:, j].numpy(), col.numpy(), rtol=1e-13, atol=1e-14)


def test_f32_factor_storage():
    m = MATS["grid12"]()
    m32 = st.csmat(m.shape, m.indptr, m.indices, np.asarray(m.data, np.float32),
                   storage="csr", validate=False)
    want = JLdl().fill_in_reduction(FILL_ND).check_symmetry(False).numeric(m32)
    got = Ldl().fill_in_reduction(FILL_ND).check_symmetry(False).numeric(port_of(m32))
    assert got.l_data.dtype == torch.float32
    np.testing.assert_array_equal(got.l_data.numpy(), np.asarray(want.l_data))
    b = np.linspace(1.0, 2.0, 144)
    np.testing.assert_allclose(got.solve(b).numpy(), np.asarray(want.solve(b)), rtol=1e-12)


@pytest.mark.parametrize("backend", t_ldl.PANEL_BACKENDS)
def test_panel_backends_and_super_solve(backend):
    """Every panel backend on the 12² grid (nd) against the host numeric,
    and ``solve(method="super")`` on its factor; an unknown backend still
    raises."""
    m = port_of(MATS["grid12"]())
    sym = Ldl().fill_in_reduction("nd").symbolic(m)
    host = sym.factor(m, backend="host")
    num = LdlNumeric.factor(sym, m, backend=backend)
    np.testing.assert_allclose(num.l_data.numpy(), host.l_data.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(num.d.numpy(), host.d.numpy(), rtol=1e-10)
    b = np.linspace(1.0, 2.0, 144)
    assert num.solve_method("auto") == "super"
    np.testing.assert_allclose(num.solve(b, method="super").numpy(),
                               host.solve(b, method="levels").numpy(), rtol=1e-10)
    with pytest.raises(ValueError, match="backend"):
        sym.factor(m, backend="bogus")


def test_factor_capacity_guard():
    with pytest.raises(CapacityError, match="factor nnz"):
        t_ldl._check_factor_capacity(2**31)
    t_ldl._check_factor_capacity(2**31 - 1)


@pytest.mark.gpu
def test_factor_and_solve_on_card():
    """The host numeric of a CUDA matrix lands on the card, and its
    solves there agree with the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = MATS["grid12"]()
    card = from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), device="cuda")
    num = Ldl().fill_in_reduction("nd").numeric(card)
    assert num.l_data.device.type == "cuda"
    b = np.random.default_rng(0).standard_normal((144, 3))
    cpu = Ldl().fill_in_reduction("nd").numeric(port_of(m))
    for method in ("levels", "flat"):
        got = num.solve(torch.from_numpy(b).cuda(), method=method)
        np.testing.assert_allclose(got.cpu().numpy(), cpu.solve(b, method=method).numpy(),
                                   rtol=RTOL, atol=RTOL)
    dev = Ldl().fill_in_reduction("nd").numeric(card, backend="device")
    np.testing.assert_allclose(dev.l_data.cpu().numpy(), num.l_data.cpu().numpy(), atol=RTOL)
