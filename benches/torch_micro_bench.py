"""Micro-benchmarks of sparse-vector operations on the card, the
counterpart of ``benches/micro_bench.py`` for the PyTorch/CUDA port.  The
cases mirror the bencher suite of the Rust library the JAX package was
modelled on (``suite.rs``, ``sparse_dense_products.rs``, ``sorting.rs``):

* CsVec negation (dim 100,000, 10,000 entries);
* the skewed sparse·dense dot: dim 1e6 with 3 entries;
* CsVec × CsMat: a 1 %-dense vector times a 10,000² matrix of density 1e-3;
* sorted against unsorted construction (dim 9,000, 900 entries).

Each time is the least over 3 rounds of µs per call over a run of calls
(50; 20 for the product), between two CUDA events on a card or on the host
clock; construction includes the host-to-device copy of its arrays.

Run from the repository root on a machine with one GPU:
``python3 benches/torch_micro_bench.py``; ``--device cpu`` runs the same
cases on the CPU.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sprs_tpu_torch.formats.csvec import csvec, csvec_from_dense, csvec_from_unsorted  # noqa: E402
from sprs_tpu_torch.utils import rand_csr  # noqa: E402
from sprs_tpu_torch.utils.profile import bench_device, card, chain_time_best  # noqa: E402


def timeit(f, like, iters=50):
    """The least over 3 rounds of seconds per call of ``iters`` calls of
    ``f()`` (which returns a tensor); ``like`` is a tensor on the device
    that sets the clock."""
    return chain_time_best(lambda _: f(), like, iters=iters, rounds=3)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    rng = np.random.default_rng(0)
    out = {"backend": device.type, "card": card() if device.type == "cuda" else None}

    # csvec neg (suite.rs)
    v = csvec(100_000, np.arange(0, 100_000, 10, dtype=np.int32), rng.standard_normal(10_000),
              device=device)
    out["csvec_neg_us"] = timeit(lambda: (-v).data, v.data) * 1e6

    # sparse-dense dot, dim 1e6 / nnz 3 (sparse_dense_products.rs)
    sv = csvec(1_000_000, np.array([2, 500_000, 999_999], np.int32), np.array([1.0, 2.0, 3.0]),
               device=device)
    dense = torch.from_numpy(rng.standard_normal(1_000_000)).to(device)
    out["sparse_dense_dot_us"] = timeit(lambda: sv.dot_dense(dense), dense) * 1e6

    # csvec x csmat product
    m = rand_csr((10_000, 10_000), 1e-3, seed=1, device=device)
    vv = csvec_from_dense(
        np.where(rng.random(10_000) < 0.01, rng.standard_normal(10_000), 0.0), device=device
    )
    out["csvec_mat_product_us"] = timeit(lambda: (vv @ m).data, vv.data, iters=20) * 1e6

    # sorted vs unsorted construction (sorting.rs: dim 9000, nnz 900)
    idx = np.sort(rng.choice(9000, 900, replace=False)).astype(np.int32)
    dat = rng.standard_normal(900)
    out["sorted_construction_us"] = timeit(lambda: csvec(9000, idx, dat, device=device).data, dense) * 1e6
    shuf = rng.permutation(900)
    out["unsorted_construction_us"] = timeit(
        lambda: csvec_from_unsorted(9000, idx[shuf], dat[shuf], device=device).data, dense) * 1e6

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
