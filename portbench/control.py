#!/usr/bin/env python3
"""Readings that the correctness limits are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed: one run of the cell with a window of a single job (after its
two warm-up jobs), the check's numbers of the program and, for the control
seeds, of the control: the reference in bfloat16 put in the program's
place, the step the limits have to reject. One JSON line a seed. The
benchmark's own runs never run the control.
"""

import argparse
import json
import sys

import run
from harness.spec import Cell


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    if not run.torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run.run_cell(cell, seed, 0.0, False, control=seed in controls)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "checks": result["checks"], "control": result.get("control"),
                          "control_notes": result.get("control_notes"),
                          "notes": result["notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
