"""i32-ceiling guards of the PyTorch port, the counterpart of
tests/test_capacity_guards.py: operations whose caps, product counts or
factor sizes would exceed 2^31 raise CapacityError / StructureError
instead of silently wrapping int32 indices, each naming the port's own
way around the limit, and the row-block partition recipe is exact.
"""

import numpy as np
import pytest
import torch

import sprs_tpu_torch as st
from sprs_tpu_torch.errors import CapacityError, StructureError
from sprs_tpu_torch.ops.spgemm import spgemm

DEV = "cpu"


def _tiny():
    return st.from_dense(np.array([[1.0, 2.0], [0.0, 3.0]]), device=DEV)


class TestI32Guards:
    def test_spgemm_prod_cap_over_i32(self):
        m = _tiny()
        with pytest.raises(CapacityError, match="row-chunked|slice_outer"):
            spgemm(m, m, prod_cap=2**31 + 5)

    def test_spgemm_out_cap_over_i32(self):
        m = _tiny()
        with pytest.raises(CapacityError, match="slice_outer"):
            spgemm(m, m, prod_cap=4, out_cap=2**31 + 5)

    def test_constructor_cap_over_i32(self):
        from sprs_tpu_torch.formats.csmat import csmat

        with pytest.raises(StructureError):
            csmat(
                (2, 2),
                np.array([0, 1, 2]),
                np.array([0, 1]),
                np.array([1.0, 2.0]),
                cap=2**31 + 5,
                validate=False,
                device=DEV,
            )

    def test_ldl_lnz_guard_fires(self):
        # a real >2^31-lnz factor cannot be built in a test; the guard
        # helper is exercised directly at the boundary values, and its
        # message names the fill-reducing ordering and the iterative way
        from sprs_tpu_torch.linalg.ldl import _check_factor_capacity

        _check_factor_capacity(2**31 - 1)  # at the limit: fine
        with pytest.raises(CapacityError, match=r"fill_in_reduction\('nd'\).*method='cg'"):
            _check_factor_capacity(2**31)


class TestScaleRecipes:
    def test_row_block_partition_recipe(self):
        # the row-block recipe that the SpGEMM hints name, at miniature
        # scale: row-block products equal the single-call result,
        # blockwise spmv is exact
        rng = np.random.default_rng(3)
        da = rng.normal(size=(9, 7)) * (rng.random((9, 7)) < 0.4)
        db = rng.normal(size=(7, 8)) * (rng.random((7, 8)) < 0.4)
        a, b = st.from_dense(da, device=DEV), st.from_dense(db, device=DEV)
        full = st.spgemm(a, b).to_dense().numpy()
        cuts = [(0, 4), (4, 9)]
        blocks = [
            st.spgemm(a.slice_outer(r0, r1), b) for r0, r1 in cuts
        ]
        stacked = np.concatenate(
            [c.to_dense().numpy() for c in blocks], axis=0
        )
        np.testing.assert_allclose(stacked, full, rtol=1e-6)
        x = rng.normal(size=8)
        y_blocks = np.concatenate(
            [st.spmv(c, torch.from_numpy(x)).numpy() for c in blocks]
        )
        np.testing.assert_allclose(
            y_blocks, full @ x, rtol=1e-5
        )
