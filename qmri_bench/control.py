"""The control of a cell, and the program's readings over many seeds, in one
process on the card:

    python3 -m qmri_bench.control --workload <cell> --seconds 2 --seeds 11 12 13 ...

For each seed: a run of the cell with a short window at its own load,
judged as the benchmark judges it, and the same answers replaced by the
plain reference computed one precision step below the configuration's
(float32 -> bfloat16, float64 -> float32). The limit of each number lies
between the largest reading of the program (the lower reading) and the
smallest reading of the control (the upper one). The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from qmri_bench.run import run_cell

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lower, upper = {}, {}
    for seed in args.seeds:
        r = run_cell(args.workload, seed, args.seconds, 0, device, control=True)
        program = {k: c["value"] for k, c in r["checks"].items()}
        print(json.dumps({"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                          "program": program, "control": r["control"]}), flush=True)
        for k, v in program.items():
            lower[k] = max(lower.get(k, -math.inf), v)
        for k, v in r["control"].items():
            upper[k] = min(upper.get(k, math.inf), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
