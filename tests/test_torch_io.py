"""The port's IO (``sprs_tpu_torch.io``) against the JAX package's
``sprs_tpu.io``: Matrix Market text equal byte for byte for every kind
and symmetry, the same triplets read back (clean bodies and bodies with
comments among the entries), every malformed payload refused with the
same error, npz files cross-loaded in both directions with the
adversarial ones refused, and checkpoint round trips (bit-equal leaves,
a corrupted tree refused, a pickled object never run).
"""

import io
import os
import pickle

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as tt
from sprs_tpu import io as jio
from sprs_tpu.utils.fixtures import dense_a, dense_spd
from sprs_tpu_torch import io as tio
from sprs_tpu_torch.errors import StructureError
from tests.test_io import (
    HERMITIAN_MM,
    INTEGER_MM,
    PATTERN_MM,
    SIMPLE_MM,
    SKEW_MM,
    SYMMETRIC_MM,
    TestMalformed,
)

FIXTURES = {"simple": SIMPLE_MM, "symmetric": SYMMETRIC_MM, "skew": SKEW_MM,
            "hermitian": HERMITIAN_MM, "pattern": PATTERN_MM, "integer": INTEGER_MM}
MALFORMED = next(m for m in TestMalformed.test_rejected.pytestmark if m.name == "parametrize").args[1]


def skew(n=6, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
    return np.tril(a, -1) - np.tril(a, -1).T


def both(dense, dtype=None):
    d = dense if dtype is None else dense.astype(dtype)
    return st.from_dense(d), tt.from_dense(d, device="cpu")


def triplets(t):
    return t.row_inds(), t.col_inds(), t.data()


def assert_same_triplets(got, want):
    for g, w in zip(triplets(got), triplets(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def outcome(fn, *args):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn(*args)
    except (ValueError, st.StructureError, tt.StructureError) as e:
        return type(e).__name__, str(e)


# -- writer ------------------------------------------------------------------


WRITE_CASES = {
    "real_general": (lambda: both(dense_a()), {}),
    "real_float32": (lambda: both(dense_a(), np.float32), {}),
    "real_symmetric": (lambda: both(dense_spd(8)), {"symmetry": "symmetric"}),
    "real_skew": (lambda: both(skew()), {"symmetry": "skew-symmetric"}),
    "real_hermitian": (lambda: both(dense_spd(6)), {"symmetry": "hermitian"}),
    "complex": (lambda: both(np.array([[1 + 2j, 0], [0.5j, 3 - 4j]])), {}),
    "complex_hermitian": (lambda: both(np.array([[2.0, 1 - 3j], [1 + 3j, 0.0]])),
                          {"symmetry": "hermitian"}),
    "pattern": (lambda: both(dense_a()), {"kind": "pattern"}),
    "pattern_symmetric": (lambda: both(dense_spd(5)), {"kind": "pattern", "symmetry": "symmetric"}),
    "integer_trimat": (lambda: (jio.loads(INTEGER_MM), tio.loads(INTEGER_MM)), {}),
    "integer_from_real": (lambda: both(np.array([[3.0, 0], [-7.0, 2.0]])), {"kind": "integer"}),
    "trimat_real": (lambda: (jio.loads(SIMPLE_MM), tio.loads(SIMPLE_MM)), {}),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_dumps_equal_to_jax(case):
    make, kw = WRITE_CASES[case]
    jm, pm = make()
    text = tio.dumps(pm, **kw)
    assert text == jio.dumps(jm, **kw)
    # and it reads back to the same triplets in both packages
    assert_same_triplets(tio.loads(text), jio.loads(text))


def test_write_refuses_what_jax_refuses():
    _, pm = both(dense_a()[:, :4])
    for kw in ({"symmetry": "symmetric"}, {"symmetry": "upper"}):
        with pytest.raises(tio.MatrixMarketError):
            tio.dumps(pm, **kw)


# -- reader ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FIXTURES))
def test_read_fixtures_equal_to_jax(name):
    text = FIXTURES[name]
    got, want = tio.loads(text), jio.loads(text)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert_same_triplets(got, want)
    csr = tio.read_matrix_market_csr(io.StringIO(text), device="cpu")
    np.testing.assert_array_equal(csr.to_dense().numpy(), want.to_dense())


def _random_file(kind, symmetry, n=40, entries=300, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, entries)
    c = rng.integers(0, n, entries)
    if symmetry != "general":
        r, c = np.maximum(r, c), np.minimum(r, c)
        if symmetry == "skew-symmetric":
            keep = r != c
            r, c = r[keep], c[keep]
    vals = {
        "real": lambda k: [repr(float(v)) for v in rng.standard_normal(k)],
        "integer": lambda k: [str(int(v)) for v in rng.integers(-9, 10, k)],
        "complex": lambda k: [f"{float(a)!r} {float(b)!r}" for a, b in rng.standard_normal((k, 2))],
        "pattern": lambda k: [""] * k,
    }[kind](len(r))
    lines = [f"{a + 1} {b + 1} {v}".rstrip() for a, b, v in zip(r, c, vals)]
    return f"%%MatrixMarket matrix coordinate {kind} {symmetry}\n% x\n{n} {n} {len(lines)}\n", lines


PARSE_CASES = [(k, s) for k in ("real", "integer", "complex", "pattern")
               for s in ("general", "symmetric", "skew-symmetric", "hermitian")
               if k != "pattern" or s in ("general", "symmetric")]


@pytest.mark.parametrize("kind,symmetry", PARSE_CASES)
def test_bulk_and_line_parse_equal_to_jax(kind, symmetry):
    """A clean body and the same body with a comment and a blank line
    among the entries give the JAX package's triplets, duplicates
    included, in its order."""
    head, lines = _random_file(kind, symmetry)
    clean = head + "\n".join(lines) + "\n"
    mixed = head + "\n".join(lines[:10] + ["% between", "   "] + lines[10:]) + "\r\n"
    want = jio.loads(clean)
    for text in (clean, mixed):
        assert_same_triplets(tio.loads(text), want)


def _late_faults():
    head, lines = _random_file("real", "general", entries=50, seed=4)
    body = "\n".join(lines)
    skew_head, skew_lines = _random_file("real", "skew-symmetric", entries=50, seed=5)
    return {
        "field_count_mid": head + "\n".join(lines[:20] + ["3 4 1.0 2.0", "5 6"] + lines[22:]),
        "bad_token": head + body.replace(lines[30], "7 8 abc"),
        "bad_index": head + body.replace(lines[30], "x 8 1.0"),
        "out_of_range_last": head + body.replace(lines[-1], "41 1 1.0"),
        "zero_index": head + body.replace(lines[5], "0 1 1.0"),
        "too_many": head + body + "\n1 1 1.0\n",
        "too_few": head + "\n".join(lines[:-1]),
        "skew_diagonal_last": skew_head + "\n".join(skew_lines + ["3 3 1.0"]).replace(
            f" {len(skew_lines)}\n", f" {len(skew_lines) + 1}\n", 1),
        "missing_size": "%%MatrixMarket matrix coordinate real general\n% only comments\n",
        "empty": "%%MatrixMarket matrix coordinate real general\n0 0 0\n",
    }


LATE_FAULTS = _late_faults()


@pytest.mark.parametrize("text", MALFORMED + list(LATE_FAULTS.values()),
                         ids=[f"malformed{i}" for i in range(len(MALFORMED))] + list(LATE_FAULTS))
def test_malformed_refused_as_jax(text):
    got, want = outcome(tio.loads, text), outcome(jio.loads, text)
    if want[0] == "ok":
        assert got[0] == "ok"
        assert_same_triplets(got[1], want[1])
    else:
        assert got == want
    if text in MALFORMED:
        assert got[0] == "MatrixMarketError"


def test_file_roundtrip_of_symmetric_write(tmp_path):
    """write_matrix_market_sym then read_matrix_market_csr: the CsMat
    equals the original array for array (capacity included)."""
    pm = tt.utils.dirichlet_laplacian((9, 7), device="cpu")
    path = str(tmp_path / "lap.mtx")
    tio.write_matrix_market_sym(path, pm)
    back = tio.read_matrix_market_csr(path, device="cpu")
    for name in ("indptr", "indices", "data"):
        assert torch.equal(getattr(back, name), getattr(pm, name))
    assert back.cap == pm.cap
    assert open(path).read() == jio.dumps(st.utils.dirichlet_laplacian((9, 7)), symmetry="symmetric")


# -- npz ---------------------------------------------------------------------


def _arrays(m):
    return [np.asarray(getattr(m, k)) if not isinstance(getattr(m, k), torch.Tensor)
            else getattr(m, k).numpy() for k in ("indptr", "indices", "data")]


@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_npz_cross_load(tmp_path, storage):
    jm = st.from_dense(dense_a(), storage=storage).with_cap(20)
    pm = tt.from_dense(dense_a(), storage=storage, device="cpu").with_cap(20)
    tio.save_npz(str(tmp_path / "p.npz"), pm)
    jio.save_npz(str(tmp_path / "j.npz"), jm)
    from_port = jio.load_npz(str(tmp_path / "p.npz"))
    from_jax = tio.load_npz(str(tmp_path / "j.npz"), device="cpu")
    for got, want in ((from_port, jm), (from_jax, pm)):
        assert got.storage == storage and got.cap == 20 and got.shape == (5, 5)
        for g, w in zip(_arrays(got), _arrays(want)):
            np.testing.assert_array_equal(g, w)


def test_npz_cross_load_csvec(tmp_path):
    jv = st.csvec(9, [1, 4], [2.0, -1.0], cap=5)
    pv = tt.csvec(9, [1, 4], [2.0, -1.0], cap=5, device="cpu")
    tio.save_npz(str(tmp_path / "p.npz"), pv)
    jio.save_npz(str(tmp_path / "j.npz"), jv)
    a = jio.load_npz(str(tmp_path / "p.npz"))
    b = tio.load_npz(str(tmp_path / "j.npz"), device="cpu")
    assert a.cap == b.cap == 5 and int(a.nnz) == b.nnz == 2
    np.testing.assert_array_equal(np.asarray(a.to_dense()), b.to_dense().numpy())
    np.testing.assert_array_equal(b.to_dense().numpy(), pv.to_dense().numpy())


ADVERSARIAL = {
    "non_monotone": dict(indptr=np.array([0, 2, 1], np.int32), indices=np.array([0, 1], np.int32)),
    "unsorted": dict(indptr=np.array([0, 2, 2], np.int32), indices=np.array([1, 0], np.int32)),
    "out_of_range": dict(indptr=np.array([0, 1, 2], np.int32), indices=np.array([0, 5], np.int32)),
    "nnz_over_cap": dict(indptr=np.array([0, 2, 3], np.int32), indices=np.array([0, 1], np.int32)),
    "first_not_zero": dict(indptr=np.array([1, 2, 2], np.int32), indices=np.array([0, 1], np.int32)),
    "cap_mismatch": dict(indptr=np.array([0, 1, 2], np.int32), indices=np.array([0, 1], np.int32),
                         cap=3),
    "short_indptr": dict(indptr=np.array([0, 2], np.int32), indices=np.array([0, 1], np.int32)),
}


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_adversarial_npz_refused_by_both(tmp_path, name):
    fields = dict(format="csmat", data=np.array([1.0, 2.0]), shape=np.array([2, 2]),
                  storage="csr", cap=2)
    fields.update(ADVERSARIAL[name])
    path = str(tmp_path / "bad.npz")
    np.savez(path, **fields)
    with pytest.raises(st.StructureError):
        jio.load_npz(path)
    with pytest.raises(StructureError):
        tio.load_npz(path, device="cpu")


def test_npz_refuses_csvec_over_cap_unknown_format_and_pickles(tmp_path):
    bad_vec = str(tmp_path / "v.npz")
    np.savez(bad_vec, format="csvec", indices=np.array([0, 1], np.int32), data=np.ones(2),
             nnz=3, dim=4, cap=2)
    unknown = str(tmp_path / "u.npz")
    np.savez(unknown, format="coo")
    for path in (bad_vec, unknown):
        with pytest.raises(st.StructureError):
            jio.load_npz(path)
        with pytest.raises(StructureError):
            tio.load_npz(path, device="cpu")
    pickled = str(tmp_path / "p.npz")
    np.savez(pickled, format=np.array([{"x": 1}], dtype=object))
    with pytest.raises(ValueError):
        tio.load_npz(pickled, device="cpu")


# -- checkpoints ---------------------------------------------------------------


def _banded(n=12):
    d = np.zeros((n, n))
    for off in (-1, 0, 1):
        np.fill_diagonal(d[max(0, -off):, max(0, off):], 2.0 + off)
    return d


def _leaves_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a) is type(b)
        for k in a.__dataclass_fields__:
            _leaves_equal(getattr(a, k), getattr(b, k))
    else:
        assert a == b


def test_checkpoint_roundtrip_mixed_format_tree(tmp_path):
    d = _banded()
    m = tt.from_dense(d, device="cpu")
    big = torch.arange(100_000, dtype=torch.float64)
    tree = {
        "mat": m,
        "csc": tt.from_dense(dense_a(), storage="csc", device="cpu").with_cap(11),
        "dia": m.to_dia(),
        "ell": m.to_ell(),
        "bsr": m.to_bsr(4),
        "vec": tt.csvec_from_dense(np.array([0.0, 1.0, 0.0, 2.0]), device="cpu"),
        "view": big[10:13],
        "ints": torch.arange(5, dtype=torch.int32),
        "host": np.arange(6.0).reshape(2, 3),
        "meta": [1, 2.5, "x", None, True, (3, 4)],
        7: {"nested": (m.to_ell(), torch.ones(2, dtype=torch.complex128))},
    }
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, tree)
    back = tio.load_checkpoint(path)
    _leaves_equal(tree, back)
    np.testing.assert_array_equal(back["dia"].to_dense().numpy(), d)
    np.testing.assert_array_equal(back["bsr"].to_dense().numpy(), d)
    # a view is saved as its own three values, not its base's storage
    assert os.path.getsize(os.path.join(path, tio.checkpoint.LEAVES_FILE)) < 100_000
    cpu = tio.load_checkpoint(path, device="cpu")
    assert cpu["mat"].device.type == "cpu"


def test_checkpoint_dense_matches_jax_checkpoint(tmp_path):
    """The same tree through both packages restores to the same arrays."""
    d = _banded(8)
    jtree = {"mat": st.from_dense(d), "x": np.arange(3.0)}
    ptree = {"mat": tt.from_dense(d, device="cpu"), "x": np.arange(3.0)}
    jio.save_checkpoint(str(tmp_path / "j"), jtree)
    tio.save_checkpoint(str(tmp_path / "p"), ptree)
    jb = jio.load_checkpoint(str(tmp_path / "j"))
    pb = tio.load_checkpoint(str(tmp_path / "p"))
    for g, w in zip(_arrays(pb["mat"]), _arrays(jb["mat"])):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pb["x"], np.asarray(jb["x"]))


def test_corrupted_checkpoint_refused(tmp_path):
    m = tt.from_dense(np.array([[1.0, 2.0], [3.0, 4.0]]), device="cpu")
    bad = tt.CsMat(m.indptr, m.indices.flip(0), m.data, m.shape, m.storage)  # unsorted rows
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, {"mat": [bad]})
    with pytest.raises(StructureError):
        tio.load_checkpoint(path)
    assert torch.equal(tio.load_checkpoint(path, validate=False)["mat"][0].indices, bad.indices)
    with open(os.path.join(path, tio.checkpoint.TREE_FILE), "w") as f:
        f.write('{"t": "tensor", "i": 9, "device": "cpu"}')
    with pytest.raises(StructureError):
        tio.load_checkpoint(path)


class _Boom:
    ran = []

    def __reduce__(self):
        return (_Boom.ran.append, ("ran",))


def test_checkpoint_holding_a_pickled_object_refused(tmp_path):
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, {"x": torch.ones(2)})
    torch.save([torch.ones(2), _Boom()], os.path.join(path, tio.checkpoint.LEAVES_FILE))
    with pytest.raises(pickle.UnpicklingError):
        tio.load_checkpoint(path)
    assert _Boom.ran == []
    with pytest.raises(TypeError):
        tio.save_checkpoint(str(tmp_path / "ck2"), {"x": object()})


@pytest.mark.gpu
def test_io_roundtrips_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pm = tt.utils.dirichlet_laplacian((16, 16), device="cuda")
    path = str(tmp_path / "lap.mtx")
    tio.write_matrix_market_sym(path, pm)
    back = tio.read_matrix_market_csr(path, device="cuda")
    assert back.device.type == "cuda" and torch.equal(back.data, pm.data)
    tio.save_npz(str(tmp_path / "m.npz"), pm)
    assert torch.equal(tio.load_npz(str(tmp_path / "m.npz"), device="cuda").indices, pm.indices)
    tio.save_checkpoint(str(tmp_path / "ck"), {"a": pm, "dia": pm.to_dia()})
    ck = tio.load_checkpoint(str(tmp_path / "ck"))
    assert ck["a"].device.type == "cuda" and torch.equal(ck["dia"].data, pm.to_dia().data)
