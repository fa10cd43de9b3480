"""The benchmark of ``sprs_tpu_torch`` on one NVIDIA H100.

Usage, from the root of a checkout::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``<cell>`` is a ``workloads`` entry of ``BENCHMARK.json``.  The run makes
its inputs on the card from ``--seed``, sets the cell up and warms it
(``setup_s``), runs a closed loop of the cell's requests for
``--seconds`` seconds, checks a seeded sample of the answers against a
plain PyTorch reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window), ``device`` and, last,
``checks`` (each compared number beside its limit; the same lines end
standard error).  It exits non-zero, with no result, where there is no
CUDA card or fewer than the cell asks for, and where JAX or the JAX
package (``sprs_tpu``) was loaded.

Caches stay inside the checkout, at fixed paths: the program builds its
CUDA kernels with ``nvcc`` into ``sprs_tpu_torch/_build/`` on a
checkout's first run (later runs load them), and ``.bench_cache/``
holds the CUDA, Triton and extension caches.  The profiler's trace is
written to the run's temporary directory and deleted once read.

The harness is driven by files found by name (``harness/spec.py``):
``configs/<config>.json``, ``generators/<generator>.py``,
``traffic/<mix>.json`` with its ``traffic/<kind>.py``,
``workloads/<cell>.json`` (limits of the check) and
``metrics/<metric>.py``.  The plain references are in ``reference/``.

Tests: ``python -m pytest benchmark/tests -q`` on the CPU; the tests
marked ``gpu`` run on a card with ``python -m pytest benchmark/tests -q
-m gpu``.  ``benchmark/calibrate.py`` takes the readings that the
limits were set from (see its docstring).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Fixed cache paths inside the checkout and one CPU thread, set
    before torch loads."""
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # one caller, few threads
        os.environ[var] = "1"
    for p in (str(ROOT), str(BENCH_DIR)):
        if p not in sys.path:
            sys.path.insert(0, p)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "not read"
    return out.splitlines()[0] if out else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    t_torch = time.perf_counter()
    from harness.guard import forbidden_modules
    from harness.loop import report_checks, run_cell
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA card(s), found {have}: no result", file=sys.stderr)
        return 2
    print(f"import_torch_s {t_torch - T_START:.3f} to_cell_s {time.perf_counter() - T_START:.3f}",
          file=sys.stderr)
    result = run_cell(cell, args.seed % 2**63, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print(f"card {card_line()}", file=sys.stderr)
    report_checks(result)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
