"""The readings that each cell's limits are set from, on a card, at the
cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 --seconds 3

For every seed in ``--seeds`` it runs the cell as ``run.py`` does (a
short window at the cell's load, then the check) and keeps each compared
number: the largest over these sound runs is the lower reading.  For
every seed in ``--control-seeds`` it runs the control: the same cell
with the program switched to the nearest precision below the one the
configuration states (float32 for float64, bfloat16 for float32), which
the port supports on every route; the smallest of its numbers is the
upper reading.  One JSON line per run, then a summary line.  The
benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import _environment  # noqa: E402


def control_cell(cell):
    """The cell with its configuration's precision one step lower."""
    from harness.program import LOWER

    c = copy.copy(cell)
    c.config = dict(cell.config, dtype=LOWER[cell.config["dtype"]])
    return c


def readings(cell, seeds, control_seeds, seconds, device, log=sys.stderr):
    """([program result], [control result]) of ``run_cell`` per seed."""
    from harness.loop import run_cell

    program = [run_cell(cell, s, seconds, False, device, time.perf_counter(), log=log)
               for s in seeds]
    control = [run_cell(control_cell(cell), s, seconds, False, device, time.perf_counter(),
                        log=log) for s in control_seeds]
    return program, control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    program, control = readings(cell, seeds, control_seeds, args.seconds, "cuda:0")
    for side, runs, ss in (("program", program, seeds), ("control", control, control_seeds)):
        for s, r in zip(ss, runs):
            print(json.dumps({"side": side, "seed": s, "correct": r["correct"],
                              "attempted": r["attempted"], "failed": r["failed"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()}}))
    names = sorted({k for r in program + control for k in r["checks"]})
    summary = {
        k: {"lower": max(r["checks"][k]["value"] for r in program),
            "upper": min(r["checks"][k]["value"] for r in control),
            "limit": cell.limits.get(k)}
        for k in names
    }
    print(json.dumps({"workload": args.workload, "seconds": time.perf_counter() - T_START,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
