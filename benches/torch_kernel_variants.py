"""A/B of design variants of kernels K2 and K3 on one card.

Each variant is the committed source with a few constants or lines
replaced; all are built with the package's nvcc flags into
``sprs_tpu_torch/_build/variants/`` and timed in one process, in two
rounds, by the profiler's device time per launch, after a check against
the plain version.

Run from the repository root on a machine with one H100:
``python3 benches/torch_kernel_variants.py``.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from sprs_tpu_torch.formats.bsr import bsr_random, bsr_spmm_plain  # noqa: E402
from sprs_tpu_torch.ops.cuda import bsr_spmm as k3  # noqa: E402
from sprs_tpu_torch.ops.cuda import build  # noqa: E402
from sprs_tpu_torch.ops.cuda import dia_spmm as k2  # noqa: E402
from sprs_tpu_torch.ops.cuda.dia_spmv import dia_tile  # noqa: E402
from sprs_tpu_torch.utils import grid_laplacian  # noqa: E402

OUT = build.BUILD_DIR / "variants"

# K3: keep one wgmma group in flight and release the previous stage
K3_PIPELINED = (
    '''    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    if (lane == 0) mbar_arrive(&empty[s]);
  }
''',
    '''    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it + kTcStages - 1) % kTcStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
''',
)


def stages(n):
    return ("constexpr int kTcStages = 4;", f"constexpr int kTcStages = {n};")


def min_blocks(n):
    return ("constexpr int kMinBlocks = 3;", f"constexpr int kMinBlocks = {n};")


# name -> (source, replacements, K2 CTAs per SM, K2 rows per run)
VARIANTS = {
    "k3 as committed (4 stages, 1 CTA/SM)": ("bsr_spmm", [], None, None),
    "k3 pipelined": ("bsr_spmm", [K3_PIPELINED], None, None),
    "k3 pipelined, 3 stages (2 CTAs/SM)": ("bsr_spmm", [K3_PIPELINED, stages(3)], None, None),
    "k3 pipelined, 6 stages": ("bsr_spmm", [K3_PIPELINED, stages(6)], None, None),
    "k2 as committed (3 CTAs/SM, 4-row runs)": ("dia_spmm", [], 3, 4),
    "k2 2 CTAs/SM": ("dia_spmm", [min_blocks(2)], 2, 4),
    "k2 4 CTAs/SM": ("dia_spmm", [min_blocks(4)], 4, 4),
    "k2 2-row runs": ("dia_spmm", [("constexpr int kRun = 4; ", "constexpr int kRun = 2; ")], 3, 2),
}


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, reps, _, _)) in enumerate(VARIANTS.items()):
        text = (build.CSRC_DIR / f"{src}.cu").read_text()
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        path = OUT / f"v{i}.cu"
        path.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"libv{i}.so"), str(path)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"built {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"libv{i}.so"))
    return libs


LL, VP, I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def k3_call(lib, bsr, x):
    fn = lib.sprs_bsr_spmm_tc_bf16
    fn.argtypes = [VP, VP, VP, VP, VP, VP, LL, LL, LL, I, LL, I, I, VP]
    k = x.shape[1]
    y = torch.empty((bsr.rows, k), dtype=x.dtype, device=x.device)
    row_ptr, order = bsr.row_order
    (gx, gy), _ = k3.launch_config(bsr.n_block_rows, k, "tc", bsr.block_size)
    err = fn(bsr.blocks.data_ptr(), bsr.bcols.data_ptr(), row_ptr.data_ptr(), order.data_ptr(),
             x.data_ptr(), y.data_ptr(), bsr.rows, bsr.cols, k, bsr.block_size, bsr.cap, gx, gy,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return y


def k2_call(lib, dia, x, blocks_per_sm, run):
    fn = getattr(lib, "sprs_dia_spmm_f32" if x.dtype == torch.float32 else "sprs_dia_spmm_f64")
    fn.argtypes = [VP, VP, VP, LL, LL, LL, LL, VP, I, I, I, I, VP]
    k = x.shape[1]
    y = torch.empty((dia.rows, k), dtype=x.dtype, device=x.device)
    runs = max(k2.THREADS // (k * x.element_size() // k2.VECTOR_BYTES), 1)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(-(-dia.rows // (runs * run)), n_sm * blocks_per_sm)
    n = dia.n_diags
    err = fn(dia.data.data_ptr(), x.data_ptr(), y.data_ptr(), dia.rows, dia.cols, dia.rows_pad, k,
             (ctypes.c_int * n)(*dia.offsets), n, 1, runs, grid, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return y


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    bf = torch.bfloat16
    k3_cases = []
    for n, seed in ((cs.BSR_N, 40), (cs.BSR_BIG_N, 42)):
        bsr = bsr_random(seed, (n, n), 128, 0.125, bf, device="cuda")
        x = cs.rhs_block(n, cs.BSR_K, bf, seed + 1)
        k3_cases.append((f"n={n} k={cs.BSR_K} bs=128 bf16", bsr, x, bsr_spmm_plain(bsr, x).float()))
    lap2 = dia_tile(grid_laplacian(cs.SPMM_GRID, torch.float32, device="cuda").to_dia())
    lap = dia_tile(grid_laplacian((cs.SOLVE_SIDE,) * 2, device="cuda").to_dia())
    k2_cases = [("2048x1024 grid f32 k=128", lap2, cs.rhs_block(lap2.cols, 128, torch.float32, 30))]
    k2_cases += [(f"1024^2 grid f64 k={k}", lap, cs.rhs_block(lap.cols, k, torch.float64, k))
                 for k in (24, 48, 256)]
    k2_refs = [k2.dia_spmm_plain(d, x) for _, d, x in k2_cases]
    for rnd in range(2):
        for name, (src, _, blocks_per_sm, run) in VARIANTS.items():
            if src == "bsr_spmm":
                for label, bsr, x, ref in k3_cases:
                    call = functools.partial(k3_call, libs[name], bsr, x)
                    rel = float((call().float() - ref).abs().max() / ref.abs().max())
                    if not rel <= 2.0**-7:
                        raise AssertionError(f"{name} {label}: rel {rel}")
                    ms = cs.device_ms(call, "bsr_spmm_tc_kernel", 30)
                    print(f"round {rnd} {name} {label}: device ms {ms!r}", flush=True)
            else:
                for (label, d, x), ref in zip(k2_cases, k2_refs):
                    call = functools.partial(k2_call, libs[name], d, x, blocks_per_sm, run)
                    err = float((call() - ref).abs().max())
                    if not err <= cs.GATE_LIMIT[x.dtype] * float(ref.abs().max()):
                        raise AssertionError(f"{name} {label}: err {err}")
                    ms = cs.device_ms(call, "dia_spmm_kernel", 30)
                    print(f"round {rnd} {name} {label}: device ms {ms!r}", flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
