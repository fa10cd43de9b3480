"""Block-sparse SpMM benchmark: tensor-core use of the BSR kernel K3, the
counterpart of ``benches/bsr_bench.py`` for the PyTorch/CUDA port.

Times Y = A @ X for block-sparse A (128×128 blocks) against the dense
``torch.matmul`` at the same shape (float32 accumulation, rounded to the
type): the speed of light of a block-sparse product is the block density
times the dense time.  Reports GFLOP/s over the stored blocks (the useful
operations) of the kernel (``ops/cuda/bsr_spmm.py::bsr_spmm_kernel``:
wgmma in bfloat16, three TF32 passes in float32) and of its plain version
(``formats/bsr.py::bsr_spmm_plain``), and the kernel's share of the ideal
time.  Each product is first held against the plain version (2⁻⁷ of
max|Y| in bfloat16, 1e-5 in float32).

Run from the repository root on a machine with one GPU:
``python3 benches/torch_bsr_bench.py [--n 4096] [--k 512] [--dtype bfloat16|float32]``;
``--device cpu`` times the plain version alone.  Prints one JSON line per
density, then the record.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sprs_tpu_torch.formats.bsr import bsr_from_dense, bsr_spmm_plain  # noqa: E402
from sprs_tpu_torch.ops.cuda.bsr_spmm import bsr_spmm_kernel  # noqa: E402
from sprs_tpu_torch.utils.profile import bench_device, card, chain_time_best  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
GATE_LIMIT = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}
DENSITIES = (0.125, 0.25, 0.5)


def chain_time(f, x0):
    """The least over 3 rounds of seconds per call of 30 calls y = f(y) in
    a row.  The bench's ``f`` reads the same X every call: products
    chained through Y would overflow within the 30 calls."""
    return chain_time_best(f, x0, iters=30, rounds=3)


def make_block_sparse(n, bs, density, seed, dtype, device="cuda"):
    """(n×n BsrMat with each bs×bs block kept with probability ``density``
    and filled with standard normals, its dense float32 array)."""
    rng = np.random.default_rng(seed)
    nb = n // bs
    keep = rng.random((nb, nb)) < density
    dense = np.zeros((n, n), np.float32)
    for i, j in zip(*np.nonzero(keep)):
        dense[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = (
            rng.standard_normal((bs, bs)).astype(np.float32)
        )
    return bsr_from_dense(dense, bs, dtype=dtype, device=device), dense


def _rel_max_diff(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    on_card = device.type == "cuda"
    n, k = args.n, args.k
    dtype = DTYPES[args.dtype]
    bs = 128

    # dense matmul reference rate at this shape
    a_dense = torch.from_numpy(np.random.default_rng(0).standard_normal((n, n))).to(device, dtype)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, k))).to(device, dtype)

    # torch.matmul sums bfloat16 products in float32 and rounds once, as
    # the JAX bench's preferred_element_type; float32 is true float32
    t_dense = chain_time(lambda _: torch.matmul(a_dense, x), x)
    dense_gflops = 2 * n * n * k / t_dense / 1e9
    out = {"n": n, "k": k, "dtype": args.dtype, "dense_matmul_GFLOPs": dense_gflops, "points": [],
           "backend": device.type, "card": card() if on_card else None}

    for density in DENSITIES:
        bsr, _ = make_block_sparse(n, bs, density, 2, dtype, device)
        useful_flops = 2 * bsr.n_blocks * bs * bs * k
        fx = lambda _, b=bsr: bsr_spmm_plain(b, x).to(dtype)  # noqa: E731
        tx = chain_time(fx, x)
        point = {"block_density": density, "n_blocks": bsr.n_blocks,
                 "plain_GFLOPs": useful_flops / tx / 1e9, "kernel_rel_max_diff": None,
                 "kernel_GFLOPs": None, "kernel_vs_ideal": None, "kernel_vs_dense_speedup": None}
        if on_card:
            fp = lambda _, b=bsr: bsr_spmm_kernel(b, x).to(dtype)  # noqa: E731
            err = _rel_max_diff(fp(x), fx(x))
            if not err <= GATE_LIMIT[dtype]:
                raise AssertionError(
                    f"bsr bench: K3 differs from its plain version by {err!r} of max|Y| at density "
                    f"{density} ({args.dtype})")
            tp = chain_time(fp, x)
            point.update({
                "kernel_rel_max_diff": err,
                "kernel_GFLOPs": useful_flops / tp / 1e9,
                # ideal time = density × dense time; the kernel's share of it
                "kernel_vs_ideal": density * t_dense / tp,
                "kernel_vs_dense_speedup": t_dense / tp,
            })
        out["points"].append(point)
        print(json.dumps(point), flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
