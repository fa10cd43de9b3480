"""The host symbolic layer of the PyTorch port against the JAX package:
elimination trees, postorder, tree levels, (reverse) Cuthill–McKee,
bandwidth, the AMD and nested-dissection orderings, supernodes, and the
port's own native library (its build under concurrency and the entry
points no other module reaches yet).

Each function runs on the native path and on the numpy fallback (the
port's loader monkeypatched to report no library); the JAX package runs
with its own native library where it is built.  Integer results must be
exactly equal.  Inputs: 12² grid Laplacians and 40-row random SPD
patterns made from seeds with numpy.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

import sprs_tpu as st
from sprs_tpu import native as j_native
from sprs_tpu.linalg import amd as j_amd
from sprs_tpu.linalg import etree as j_etree
from sprs_tpu.linalg import nd as j_nd
from sprs_tpu.linalg import ordering as j_ordering
from sprs_tpu.linalg import supernodes as j_sn
from sprs_tpu.linalg import Ldl as JLdl
from sprs_tpu_torch import native
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import amd, etree, nd, ordering, supernodes

PATHS = ["native", "numpy"]


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Run the port on its native library or on its numpy fallbacks."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.available()
    return request.param


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


def two_blocks():
    """Two disconnected 6² grids: several connected components."""
    g = st.utils.dirichlet_laplacian((6, 6)).to_dense()
    z = np.zeros_like(np.asarray(g))
    return st.from_dense(np.block([[np.asarray(g), z], [z, np.asarray(g)]]))


MATS = {
    "grid12": lambda: st.utils.dirichlet_laplacian((12, 12)),
    "random40": random_spd,
    "random40b": lambda: random_spd(seed=3, density=0.15),
    "two_blocks": two_blocks,
}


def host_pattern(m):
    nnz = int(m.nnz)
    return np.asarray(m.indptr), np.asarray(m.indices)[:nnz], m.shape[0]


@pytest.mark.parametrize("name", list(MATS))
def test_etree_postorder_levels(name, path):
    indptr, indices, n = host_pattern(MATS[name]())
    want = j_etree.etree_from_pattern(indptr, indices, n)
    got = etree.etree_from_pattern(indptr, indices, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(etree.postorder(got), j_etree.postorder(want))
    np.testing.assert_array_equal(etree.tree_levels(got), j_etree.tree_levels(want))


@pytest.mark.parametrize("start", ["next", "min_degree", "pseudo_peripheral"])
@pytest.mark.parametrize("reversed_order", [True, False])
@pytest.mark.parametrize("name", ["grid12", "random40", "two_blocks"])
def test_cuthill_mckee(name, start, reversed_order, path):
    m = MATS[name]()
    want = j_ordering.cuthill_mckee_custom(m, start=start, reversed_order=reversed_order)
    got = ordering.cuthill_mckee_custom(port_of(m), start=start, reversed_order=reversed_order)
    np.testing.assert_array_equal(got.perm, want.perm)
    assert got.connected_parts == list(want.connected_parts)
    perm = got.permutation()
    assert perm.device.type == "cpu"
    np.testing.assert_array_equal(perm.perm.numpy(), want.perm)


@pytest.mark.parametrize("name", list(MATS))
def test_rcm_and_bandwidth(name, path):
    m = MATS[name]()
    pm = port_of(m)
    assert ordering.bandwidth(pm) == j_ordering.bandwidth(m)
    np.testing.assert_array_equal(ordering.reverse_cuthill_mckee(pm).perm,
                                  j_ordering.reverse_cuthill_mckee(m).perm)
    np.testing.assert_array_equal(ordering.cuthill_mckee(pm).perm,
                                  j_ordering.cuthill_mckee(m).perm)


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


@pytest.mark.parametrize("name", list(MATS))
def test_camd_order(name, path, monkeypatch, jax_native):
    m = MATS[name]()
    if path == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
    want = np.asarray(j_amd.camd_order(m).perm)
    got = amd.camd_order(port_of(m))
    np.testing.assert_array_equal(got.perm.numpy(), want)
    np.testing.assert_array_equal(np.sort(got.perm.numpy()), np.arange(m.shape[0]))


def test_camd_numpy_fallback_refuses_large(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    big = port_of(st.utils.dirichlet_laplacian((65, 64)))
    with pytest.raises(RuntimeError, match="O\\(n²\\)"):
        amd.camd_order(big)


@pytest.mark.parametrize("leaf_size", [4, 64])
@pytest.mark.parametrize("name", list(MATS))
def test_nd_order(name, leaf_size, path):
    m = MATS[name]()
    want = np.asarray(j_nd.nd_order(m, leaf_size=leaf_size).perm)
    got = nd.nd_order(port_of(m), leaf_size=leaf_size)
    np.testing.assert_array_equal(got.perm.numpy(), want)


def factor_pattern(m, fill):
    """(l_indptr, l_indices, parent, colcount) of the JAX package's
    postordered symbolic."""
    sym = JLdl().fill_in_reduction(fill).postorder(True).check_symmetry(False).symbolic(m)
    return sym.l_indptr, sym.l_indices, sym.parent, np.diff(sym.l_indptr)


@pytest.mark.parametrize("fill", ["rcm", "nd"])
@pytest.mark.parametrize("name", ["grid12", "random40"])
def test_supernodes(name, fill, path):
    lp, li, parent, colcount = factor_pattern(MATS[name](), fill)
    want = j_sn.fundamental_supernodes(parent, colcount)
    got = supernodes.fundamental_supernodes(parent, colcount)
    np.testing.assert_array_equal(got.ptr, want.ptr)
    np.testing.assert_array_equal(got.of, want.of)
    np.testing.assert_array_equal(got.widths(), want.widths())
    for kw in ({}, {"max_zeros": 4, "max_width": 8, "rel_zeros": 0.05}):
        a = supernodes.amalgamate(got, parent, colcount, **kw)
        np.testing.assert_array_equal(a.ptr, j_sn.amalgamate(want, parent, colcount, **kw).ptr)
    rows, nrows = supernodes.supernode_structure(lp, li, got)
    j_rows, j_nrows = j_sn.supernode_structure(lp, li, want)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(nrows, j_nrows)
    for fn, j_fn in ((supernodes.amalgamate_union, j_sn.amalgamate_union),
                     (supernodes.amalgamate_subtree, j_sn.amalgamate_subtree)):
        for kw in ({}, {"max_width": 8, "rel_zeros": 0.2}):
            g_sn, g_bp, g_bf = fn(lp, li, parent, colcount, **kw)
            w_sn, w_bp, w_bf = j_fn(lp, li, parent, colcount, **kw)
            np.testing.assert_array_equal(g_sn.ptr, w_sn.ptr)
            np.testing.assert_array_equal(g_bp, w_bp)
            np.testing.assert_array_equal(g_bf, w_bf)


def test_amalgamate_union_native_equals_numpy(monkeypatch):
    """The native merger and the numpy one give one partition."""
    lp, li, parent, colcount = factor_pattern(st.utils.dirichlet_laplacian((12, 12)), "nd")
    fast = supernodes.amalgamate_union(lp, li, parent, colcount, max_width=16)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = supernodes.amalgamate_union(lp, li, parent, colcount, max_width=16)
    for a, b in zip((fast[0].ptr, fast[1], fast[2]), (slow[0].ptr, slow[1], slow[2])):
        np.testing.assert_array_equal(a, b)


def test_native_entry_points():
    """The wrappers no port module calls yet against numpy references:
    ``min_degree`` (the greedy exact minimum degree, also the numpy
    fallback of ``camd_order``), ``spgemm_host`` (scipy's product),
    ``ldl_pattern`` (the JAX package's padded row patterns) and
    ``super_rmap`` (the update row maps of the next slice's panel plans,
    by their definition)."""
    m = st.utils.dirichlet_laplacian((12, 12))
    indptr, indices, n = host_pattern(m)
    fast = native.min_degree(indptr, indices, n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "get_lib", lambda: None)
        np.testing.assert_array_equal(fast, amd.camd_order(port_of(m)).perm.numpy())

    a = m.to_scipy().tocsr()
    data = a.data.astype(np.float64)
    cp, ci, cv = native.spgemm_host(a.indptr, a.indices, data, a.indptr, a.indices, data, n)
    want = (a @ a).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(cp, want.indptr)
    np.testing.assert_array_equal(ci, want.indices)
    np.testing.assert_allclose(cv, want.data, rtol=1e-15)

    sym = JLdl().check_symmetry(False).symbolic(m)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keep = indices <= rows
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=row_ptr[1:])
    row_pattern, insert_pos, l_indices = native.ldl_pattern(
        row_ptr, indices[keep], n, sym.parent, sym.l_indptr, sym.wl, sym.nnz)
    np.testing.assert_array_equal(row_pattern, sym.row_pattern)
    np.testing.assert_array_equal(insert_pos, sym.insert_pos)
    np.testing.assert_array_equal(l_indices, sym.l_indices)

    lp, li, parent, colcount = factor_pattern(m, "nd")
    sn, bp, bf = supernodes.amalgamate_union(lp, li, parent, colcount, max_width=8)
    c0, w = sn.ptr[:-1], np.diff(sn.ptr)
    last = sn.n_snodes - 1
    pair_d = np.arange(last, dtype=np.int64)
    pair_t = np.full(last, last, dtype=np.int64)
    mr = int((w + np.diff(bp)).max())
    got = native.super_rmap(pair_d, pair_t, c0, w, bp, bf, mr)
    for p, (d, t) in enumerate(zip(pair_d, pair_t)):
        target = np.concatenate([np.arange(c0[t], c0[t] + w[t]), bf[bp[t]:bp[t + 1]]])
        below_d = bf[bp[d]:bp[d + 1]]
        want_row = np.full(mr, mr)
        hit = np.isin(target, below_d)
        want_row[: target.size][hit] = w[d] + np.searchsorted(below_d, target[hit])
        np.testing.assert_array_equal(got[p], want_row)


BUILD_SCRIPT = textwrap.dedent("""
    import sys
    from sprs_tpu_torch import native
    seconds = native.build()
    lib = native.load()
    import numpy as np
    parent = native.etree(np.array([0, 2, 4], np.int32), np.array([0, 1, 0, 1], np.int32), 2)
    print(seconds, parent.tolist())
""")


def test_native_build_from_two_processes(tmp_path):
    """Two processes build and load a fresh copy of the library at once:
    the lock lets exactly one compile, the rename leaves no partial file,
    and both load it and get the same answer."""
    pkg = tmp_path / "sprs_tpu_torch"
    (pkg / "native").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "__init__.py").write_text("")
    shutil.copy(native.__file__, pkg / "native" / "__init__.py")
    shutil.copy(native.SOURCE, pkg / "csrc" / "sprs_host.cpp")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    results = [out.split() for out, _ in outs]
    built = sorted(float(r[0]) > 0 for r in results)
    assert built == [False, True]
    assert all(" ".join(r[1:]) == "[1, -1]" for r in results)
    assert sorted(os.listdir(pkg / "_build")) == ["libsprs_host.so", "sprs_host.lock"]


def test_port_loads_its_own_library():
    """A fresh interpreter that runs the port's symbolic layer maps the
    port's library, never the JAX package's."""
    code = textwrap.dedent("""
        import numpy as np
        import sprs_tpu_torch as st
        from sprs_tpu_torch.linalg import Ldl
        from sprs_tpu_torch.utils import dirichlet_laplacian
        Ldl().fill_in_reduction("camd").numeric(dirichlet_laplacian((8, 8), device="cpu"))
        maps = open("/proc/self/maps").read()
        print("port" if "sprs_tpu_torch/_build/libsprs_host.so" in maps else "none",
              "jax" if "sprs_tpu/native/libsprs_host.so" in maps else "clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["port", "clean"]


@pytest.mark.parametrize("path_", ["native", "numpy"])
def test_gauss_seidel_paths_match_jax(path_, monkeypatch, jax_native):
    """The port's Gauss–Seidel on its native sweep and on its numpy sweep
    against the JAX package's (native) sweep: the same sweeps, the same
    residual test."""
    from sprs_tpu.linalg import gauss_seidel as j_gauss_seidel
    from sprs_tpu_torch.linalg import gauss_seidel

    if path_ == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    m = st.utils.grid_laplacian((8, 8), dtype=np.float64)
    rhs = np.zeros(64)
    rhs[36] = 1.0
    want = j_gauss_seidel(m, rhs, tol=1e-8, max_iter=300)
    got = gauss_seidel(port_of(m), rhs, tol=1e-8, max_iter=300)
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-14)
