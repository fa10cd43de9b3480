"""Weak-scaling benchmark of the distributed SpMV, the counterpart of
``benches/scaling_bench.py`` for the PyTorch/CUDA port.

Weak scaling holds the work per slot constant (``--rows-per`` rows of a
5-point grid Laplacian, float32, a (side·n) × side grid for n slots) and
grows the problem with the slots; the efficiency at n slots is
t(1) / t(n) (ideal 1.0).  Two schedules are timed, each as a chain of
``--iters`` products y = A y between two CUDA events
(``utils/profile.py::chain_time``):

* ``halo``: ``parallel/halo.py::dist_spmv_halo``, each slot receiving the
  O(halo) boundary entries of x from its neighbours;
* ``gather``: ``parallel/dist.py::dist_spmv(..., x_sharded=True)``, every
  slot gathering all of x, then ``DistCsMat.assemble``.

Beside the times, each row carries the JAX bench's byte accounting (the
bytes a slot receives per product in each schedule), the distributed
SpGEMM's communication plan (``plan_b_gather``) and the byte-model
efficiencies compute / (compute + communication).

The port's ``Mesh`` puts every slot on the one card (``--slots``, default
1 2 4 8, in place of the JAX bench's ``jax.devices()``), so its
collectives are copies within the card's memory: t(1) / t(n) is the
schedules' overhead on one card where n slots do n times the rows, not
scaling across GPUs.  The JAX bench records a one-device mesh on one TPU.

Record keys against the JAX bench's: ``n_devices`` is ``n_slots``;
``vs_target_0.70`` (the ratio to a multi-device weak-scaling target set
for the TPU, which a one-card slot-overhead ratio cannot be held to) is
left out; added are ``n_cards`` (1), ``slots_on_one_card`` (true) and ``card``, and
in each row ``halo_rel_diff`` / ``gather_rel_diff``, the largest
difference of each schedule's product from ``ops/prod.py::spmv`` of the
whole Laplacian over max|y|.  ``backend`` is the torch device type.

Run from the repository root on a machine with one GPU:
``python3 benches/torch_scaling_bench.py [--rows-per 65536] [--iters 20]
[--slots 1 2 4 8]``; ``--device cpu`` runs it on the CPU.  Prints one
JSON line per slot count, then the record as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sprs_tpu_torch.ops.prod import spmv  # noqa: E402
from sprs_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    dist_spmv,
    dist_spmv_halo,
    plan_b_gather,
    shard_csr_rows,
    shard_csr_rows_halo,
)
from sprs_tpu_torch.utils.profile import bench_device, card, chain_time  # noqa: E402
from sprs_tpu_torch.utils.special import grid_laplacian  # noqa: E402


def rel_diff(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


def bench_n(n_slots: int, rows_per: int, iters: int, device="cuda") -> dict:
    side = int(np.sqrt(rows_per))
    # rows grow with the slots, the block per slot constant
    lap = grid_laplacian((side * n_slots, side), dtype=torch.float32, device=device)
    n = lap.shape[0]
    x = torch.from_numpy(np.random.default_rng(0).random(n, dtype=np.float32)).to(device)
    mesh = Mesh([device] * n_slots, ("shards",))
    y_ref = spmv(lap, x)

    hmat = shard_csr_rows_halo(lap, n_slots, device=mesh)

    def f_halo(v):
        return dist_spmv_halo(hmat, v, mesh)[: v.shape[0]]

    halo_diff = rel_diff(f_halo(x), y_ref)
    t_halo = chain_time(f_halo, x, iters)

    dmat = shard_csr_rows(lap, n_slots, device=mesh)

    def f_ag(v):
        return dmat.assemble(dist_spmv(dmat, v, mesh, x_sharded=True))

    gather_diff = rel_diff(f_ag(x), y_ref)
    t_ag = chain_time(f_ag, x, iters)

    # bytes a slot receives per product in each schedule
    itemsize = x.element_size()
    halo_bytes = 2 * hmat.halo * itemsize  # two boundary slices
    gather_bytes = (n_slots - 1) * (n // max(n_slots, 1)) * itemsize

    # the distributed SpGEMM's plans: referenced-block gather against a
    # full all-gather of B's row blocks
    plan = plan_b_gather(dmat, dmat)
    blk_bytes = dmat.cap_per_shard * (4 + itemsize) + 4 * (dmat.rows_per_shard + 1)
    spgemm_comm = dict(
        bgather_remote_blocks=plan.comm_blocks,
        bgather_mean_blocks=round(plan.mean_blocks, 2),
        allgather_remote_blocks=plan.full_blocks,
        bgather_bytes_per_dev=plan.comm_blocks * blk_bytes,
        allgather_bytes_per_dev=plan.full_blocks * blk_bytes,
        comm_fraction=round(plan.comm_fraction, 4),
    )
    # the schedules' efficiency bound from the byte accounting alone:
    # compute bytes / (compute + communication bytes)
    compute_bytes = (
        int(lap.nnz) // max(n_slots, 1) * (4 + itemsize)  # CSR slice
        + (n // max(n_slots, 1)) * itemsize * 2  # x in, y out
    )
    model_eff = dict(
        halo_model_eff=round(compute_bytes / (compute_bytes + halo_bytes), 4),
        gather_model_eff=round(compute_bytes / (compute_bytes + gather_bytes), 4),
    )
    return dict(
        n_slots=n_slots,
        n_cards=1,
        rows=n,
        nnz=int(lap.nnz),
        halo=hmat.halo,
        halo_s=t_halo,
        gather_s=t_ag,
        halo_rel_diff=halo_diff,
        gather_rel_diff=gather_diff,
        halo_bytes_per_dev=halo_bytes,
        gather_bytes_per_dev=gather_bytes,
        spgemm_comm=spgemm_comm,
        **model_eff,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-per", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--slots", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="slot counts, all on the one device; the first is the baseline")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)

    rows = [bench_n(c, args.rows_per, args.iters, device) for c in args.slots]
    base_halo = rows[0]["halo_s"]
    base_ag = rows[0]["gather_s"]
    for r in rows:
        r["halo_weak_eff"] = base_halo / r["halo_s"]
        r["gather_weak_eff"] = base_ag / r["gather_s"]
        print(json.dumps(r), flush=True)
    final = rows[-1]
    out = {
        "metric": "weak_scaling_halo_eff",
        "value": final["halo_weak_eff"],
        "n_slots": final["n_slots"],
        "n_cards": 1,
        "slots_on_one_card": True,
        "backend": device.type,
        "card": card() if device.type == "cuda" else None,
        "rows": rows,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
