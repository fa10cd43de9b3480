"""The inputs: HPCG's stencil and GAP's kron graph at tiny sizes."""

import pytest
import torch

from harness.spec import BENCH_DIR, load_module
from reference.compress import compress
from reference.stencil27 import Stencil27

stencil27 = load_module(BENCH_DIR / "generators" / "stencil27.py", "generator")
kron = load_module(BENCH_DIR / "generators" / "kron.py", "generator")


@pytest.mark.parametrize("m", [2, 3, 4, 6])
def test_stencil_counts_symmetry_and_values(m):
    op = stencil27.operator({"nx": m, "ny": m, "nz": m}, "cpu")
    n = op["n"]
    assert n == m ** 3 and op["rows"].numel() == (3 * m - 2) ** 3
    a = torch.zeros(n, n, dtype=torch.float64)
    a[op["rows"].long(), op["cols"].long()] = op["vals"]
    assert torch.equal(a, a.T)
    assert torch.all(a.diagonal() == 26.0)
    off = a - torch.diag(a.diagonal())
    assert set(off.unique().tolist()) <= {0.0, -1.0}
    rows = op["rows"].long()
    assert torch.all(rows[1:] >= rows[:-1])  # HPCG's row order


def test_stencil_matches_the_reference_operator_in_any_numbering():
    nx, ny, nz = 4, 3, 5
    op = stencil27.operator({"nx": nx, "ny": ny, "nz": nz}, "cpu")
    n = op["n"]
    a = torch.zeros(n, n, dtype=torch.float64)
    a[op["rows"].long(), op["cols"].long()] = op["vals"]
    x = torch.randn(n, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    assert torch.allclose(Stencil27(nx, ny, nz).matvec(x), a @ x, rtol=0, atol=1e-12)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    ap = a[perm][:, perm]  # new unknown i is grid point perm[i]
    assert torch.allclose(Stencil27(nx, ny, nz, perm=perm).matvec(x), ap @ x, rtol=0, atol=1e-12)


def _kron(scale, graph_seed):
    cfg = {"scale": scale, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
           "graph_seed": graph_seed}
    return kron.edges(cfg, "cpu")


@pytest.mark.parametrize("scale", [6, 8, 10])
def test_kron_is_symmetric_without_self_loops(scale):
    e = _kron(scale, 3)
    n, rows, cols = e["n"], e["rows"].long(), e["cols"].long()
    assert n == 1 << scale
    assert rows.numel() % 2 == 0 and rows.numel() <= 2 * 16 * n
    assert torch.all(rows != cols) and rows.min() >= 0 and rows.max() < n
    fwd = torch.sort(rows * n + cols).values
    bwd = torch.sort(cols * n + rows).values
    assert torch.equal(fwd, bwd)  # every edge both ways, duplicates alike


def test_kron_dedup_leaves_unique_sorted_pairs():
    e = _kron(8, 4)
    n = e["n"]
    r, c = kron.dedup(e["rows"], e["cols"], n)
    key = r.long() * n + c.long()
    assert torch.all(key[1:] > key[:-1])
    assert key.numel() < e["rows"].numel()  # R-MAT draws repeat edges
    indptr, indices, _ = compress(e["rows"], e["cols"], torch.ones(e["rows"].numel()), n, n)
    assert int(indptr[-1]) == key.numel() and torch.equal(indices, c.long())


def test_kron_is_skewed_like_rmat():
    e = _kron(10, 5)
    deg = torch.bincount(e["rows"].long(), minlength=e["n"])
    assert deg.max() > 10 * deg.float().mean()


def test_the_configuration_fixes_the_graph():
    a, b, c = _kron(8, 11), _kron(8, 11), _kron(8, 12)
    assert torch.equal(a["rows"], b["rows"]) and torch.equal(a["cols"], b["cols"])
    assert not torch.equal(a["rows"], c["rows"])
