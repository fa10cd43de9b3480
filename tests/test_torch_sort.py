"""Kernel K6 (the 128-wide row sort) of the PyTorch port against the JAX
package's ``sort_rows_pallas``, run in interpret mode as
tests/test_pallas.py runs it.

Keys and values must be exactly equal, ties included: both packages run
the same bitonic network with the same tie rule.  The CUDA kernel itself
runs only on the card: the ``gpu``-marked test.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sprs_tpu.ops.pallas import sort_rows_pallas
from sprs_tpu_torch.ops.cuda import sort as k6
from sprs_tpu_torch.ops.cuda.sort import launch_config, sort_rows_kernel, sort_rows_plain


# +NaN with every mantissa bit set, the quiet NaN, their negatives,
# +-inf, +-0.0
NAN_AND_INF = np.array([0x7FFFFFFF, 0x7FC00000, 0xFFFFFFFF, 0xFFC00000, 0x7F800000, 0xFF800000,
                        0x00000000, 0x80000000], np.uint32).view(np.float32)


def case(kind, rows, seed):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        keys = rng.integers(0, 1 << 30, (rows, 128)).astype(np.int32)
    elif kind == "ties":
        keys = rng.integers(0, 8, (rows, 128)).astype(np.int32)
    elif kind == "zeros":  # float ties, +0.0 against -0.0 among them
        keys = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0, 2.0], np.float32), (rows, 128))
    elif kind == "nan":  # NaN and inf bit patterns among the numbers
        keys = rng.standard_normal((rows, 128)).astype(np.float32)
        pick = rng.random((rows, 128)) < 0.2
        keys[pick] = rng.choice(NAN_AND_INF, int(pick.sum()))
    else:
        keys = rng.standard_normal((rows, 128)).astype(np.float32)
    return keys, rng.random((rows, 128)).astype(np.float32)


# the cases of tests/test_pallas.py::TestSortRows, then rows that are not
# a multiple of a smaller row block, float keys with signed zeros and
# ties, and a single row
CASES = [
    ("int32", 65, 40, 512),
    ("ties", 16, 41, 512),
    ("float32", 10, 42, 512),
    ("ties", 37, 43, 16),
    ("zeros", 16, 48, 512),
    ("float32", 1, 49, 512),
]


@pytest.mark.parametrize("kind,rows,seed,rows_blk", CASES)
def test_kernel_on_cpu_equals_pallas(kind, rows, seed, rows_blk):
    keys, vals = case(kind, rows, seed)
    want_k, want_v = sort_rows_pallas(
        jnp.asarray(keys), jnp.asarray(vals), rows_blk=rows_blk, interpret=True
    )
    got_k, got_v = sort_rows_kernel(torch.from_numpy(keys), torch.from_numpy(vals), rows_blk=rows_blk)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_k.numpy(), np.sort(keys, axis=1))
    for r in range(rows):  # each key keeps its own value
        assert sorted(zip(keys[r].tolist(), vals[r].tolist())) == sorted(
            zip(got_k[r].tolist(), got_v[r].tolist())
        )


def test_plain_orders_signed_zeros_as_jax():
    """On float keys with +0.0, -0.0 and other ties, the plain version
    equals the JAX kernel bit for bit: -0.0 sorts below +0.0 as
    ``jnp.minimum`` orders them, while the values stay where the keys are
    equal as numbers (the JAX ``swap = new_key != key``)."""
    keys, vals = case("zeros", 24, 50)
    want_k, want_v = sort_rows_pallas(jnp.asarray(keys), jnp.asarray(vals), rows_blk=8, interpret=True)
    got_k, got_v = sort_rows_plain(torch.from_numpy(keys), torch.from_numpy(vals), rows_blk=8)
    np.testing.assert_array_equal(got_k.numpy().view(np.int32), np.asarray(want_k).view(np.int32))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for row in got_k.numpy():
        zeros = np.signbit(row[row == 0])
        assert zeros.size and np.array_equal(zeros, np.sort(zeros)[::-1])  # every -0.0 first


def test_plain_sorts_nan_and_inf_by_the_order_map():
    """A NaN key has a place: its bits, mapped as every float key is, so
    +NaN with every mantissa bit set (the largest int of the map) sorts
    last and -NaN first, and the kernel, which uses the same map, must put
    it there too.  Each key keeps its own value (+0.0 and -0.0 as one
    key: between them the bits move and the values stay)."""
    keys, vals = case("nan", 12, 51)
    got_k, got_v = sort_rows_plain(torch.from_numpy(keys), torch.from_numpy(vals))
    bits = keys.view(np.int32)
    order = np.sort(bits ^ ((bits >> 31) & 0x7FFFFFFF), axis=1)
    np.testing.assert_array_equal(got_k.numpy().view(np.int32), order ^ ((order >> 31) & 0x7FFFFFFF))
    assert (got_k.numpy().view(np.uint32)[:, 0] >= 0xFFC00000).all()  # a -NaN in every row
    one_zero = np.where(bits == np.int32(-(2**31)), 0, bits)
    got_bits = got_k.numpy().view(np.int32)
    got_zero = np.where(got_bits == np.int32(-(2**31)), 0, got_bits)
    for r in range(12):
        assert sorted(zip(one_zero[r].tolist(), vals[r].tolist())) == sorted(
            zip(got_zero[r].tolist(), got_v[r].tolist())
        )


def test_integer_values_ride_the_permutation():
    keys, _ = case("ties", 9, 44)
    cols = torch.arange(128, dtype=torch.int32).expand(9, -1).contiguous()
    ks, vs = sort_rows_plain(torch.from_numpy(keys), cols)
    assert vs.dtype == torch.int32
    np.testing.assert_array_equal(np.take_along_axis(keys, vs.numpy().astype(np.int64), 1), ks.numpy())


def test_width_check():
    for keys in (torch.zeros((4, 64), dtype=torch.int32), torch.zeros(128, dtype=torch.int32)):
        with pytest.raises(ValueError):
            sort_rows_kernel(keys, torch.zeros(keys.shape))
    with pytest.raises(ValueError):
        sort_rows_kernel(torch.zeros((4, 128), dtype=torch.int32), torch.zeros((5, 128)))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    keys, vals = case("int32", 8, 45)
    before, calls = sort_rows_kernel.launches, sort_rows_plain.calls
    sort_rows_kernel(torch.from_numpy(keys), torch.from_numpy(vals))
    assert sort_rows_kernel.launches == before and sort_rows_plain.calls == calls + 1


def test_launch_refusals():
    keys, vals = case("int32", 8, 46)
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    with pytest.raises(ValueError, match="CUDA"):
        k6._launch(k, v)
    k6._check(k, v)
    k6._check(k.float(), v.view(torch.int32))
    for bad_k, bad_v, err in (
        (k.long(), v, TypeError),
        (k.double(), v, TypeError),
        (k, v.double(), TypeError),
        (k, v.to(torch.int16), TypeError),
        (k.t().contiguous().t(), v, ValueError),
        (torch.zeros(8 * 128 + 1, dtype=torch.int32)[1:].view(8, 128), v, ValueError),
    ):
        with pytest.raises(err):
            k6._check(bad_k, bad_v)


@pytest.mark.parametrize(
    "key_dtype,val_dtype,match",
    [
        (torch.int64, torch.float32, "int32 or float32 keys, got torch.int64"),
        (torch.float64, torch.float32, "int32 or float32 keys, got torch.float64"),
        (torch.int32, torch.int64, "4-byte vals, got torch.int64"),
        (torch.float32, torch.float64, "4-byte vals, got torch.float64"),
    ],
)
def test_card_path_refuses_64_bit_keys_and_values(key_dtype, val_dtype, match):
    """``sort_rows_pallas`` states int32 or float32 keys (its docstring in
    sprs_tpu/ops/pallas/sort.py), and Mosaic, which lowers it on the TPU,
    has no 64-bit vector lanes: the 64-bit keys and 8-byte values that
    interpret mode happens to accept are no forms of the kernel.  The
    card path refuses them before any launch, naming what it takes."""
    import inspect

    from sprs_tpu.ops.pallas import sort as jax_sort

    assert "``keys`` must be int32 or float32" in inspect.getdoc(jax_sort.sort_rows_pallas).replace("\n", " ")
    keys, vals = case("int32", 8, 47)
    k = torch.from_numpy(keys).to(key_dtype)
    v = torch.from_numpy(vals).to(val_dtype)
    with pytest.raises(TypeError, match=re.escape(match)):
        k6._check(k, v)


@pytest.mark.parametrize("rows,n_sm,grid", [(1, 132, 1), (16, 132, 1), (17, 132, 2), (43_750, 132, 528)])
def test_launch_config(rows, n_sm, grid):
    assert launch_config(rows, n_sm) == (grid, k6.BLOCK)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int32", "ties", "float32", "zeros", "nan"])
def test_kernel_equals_plain_on_card(kind):
    """K6 on the card against its plain version, bit for bit (run where a
    GPU is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys, vals = (torch.from_numpy(a).cuda() for a in case(kind, 300, 47))
    before = sort_rows_kernel.launches
    ks, vs = sort_rows_kernel(keys, vals)
    pk, pv = sort_rows_plain(keys, vals)
    torch.cuda.synchronize()
    assert sort_rows_kernel.launches == before + 1
    assert torch.equal(ks.view(torch.int32), pk.view(torch.int32))
    assert torch.equal(vs.view(torch.int32), pv.view(torch.int32))
