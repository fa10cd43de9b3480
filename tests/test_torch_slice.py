"""The ported slice as a whole: the entry point, the heat example, the
package's doctests, and the port's independence from JAX."""

import doctest
import subprocess
import sys

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.linalg import bicgstab, gauss_seidel, jacobi


def test_entry_matches_jax_entry():
    from __graft_entry__ import entry as jax_entry
    from sprs_tpu_torch.entry import entry

    jfn, jargs = jax_entry()
    fn, args = entry(device="cpu")
    y = fn(*args)
    want = np.asarray(jfn(*jargs))
    assert y.dtype == torch.float32 and y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_heat_example_matches_jax_solvers(capsys):
    from sprs_tpu_torch.examples.heat import main

    side = 6
    out = main([str(side), "--device", "cpu"])
    assert "bicgstab(dia): iters=" in capsys.readouterr().out
    lap = st.utils.grid_laplacian((side, side), dtype=np.float64)
    rhs = np.zeros(side * side)
    rhs[(side // 2) * side + side // 2] = 1.0
    want = {
        "gauss_seidel": gauss_seidel(lap, rhs, tol=1e-8, max_iter=300),
        "jacobi": jacobi(lap, rhs, tol=1e-7, max_iter=8000, omega=0.9),
        "bicgstab": bicgstab(lap, rhs, tol=1e-8, max_iter=500),
    }
    for name, ref in want.items():
        got = out[name]
        assert got.iterations == int(ref.iterations), name
        assert got.converged
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-10, err_msg=name)


MODULES = [
    "sprs_tpu_torch",
    "sprs_tpu_torch.formats.csmat",
    "sprs_tpu_torch.linalg.bicgstab",
    "sprs_tpu_torch.linalg.lobpcg",
    "sprs_tpu_torch.linalg.expm",
    "sprs_tpu_torch.ops.spgemm",
    "sprs_tpu_torch.ops.kron",
    "sprs_tpu_torch.linalg.gmres",
    "sprs_tpu_torch.linalg.lsqr",
]


@pytest.mark.parametrize("name", MODULES)
def test_doctests(name):
    import importlib

    mod = importlib.import_module(name)
    res = doctest.testmod(mod, verbose=False)
    assert res.attempted > 0 and res.failed == 0


NEW_MODULES = [
    "sprs_tpu_torch.formats.csvec",
    "sprs_tpu_torch.ops.construct",
    "sprs_tpu_torch.ops.kron",
    "sprs_tpu_torch.ops.permutation",
    "sprs_tpu_torch.ops.spgemm",
    "sprs_tpu_torch.ops.symmetry",
    "sprs_tpu_torch.linalg.gmres",
    "sprs_tpu_torch.linalg.lsqr",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the sparse-ops slice's named first, in a
    fresh interpreter: none pulls in jax, sprs_tpu or its native library."""
    code = (
        "import sys, importlib, pkgutil, sprs_tpu_torch\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "for m in pkgutil.walk_packages(sprs_tpu_torch.__path__, 'sprs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sprs_tpu' or m.startswith('sprs_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
