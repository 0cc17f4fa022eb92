"""Readings behind a cell's correctness limits, on the chip, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6]
        [--faults half_batch,altered_logit] [--fault-seeds 7,8,9] [--seconds 2] [--out FILE]

For each seed it makes one run of the cell as ``run.py`` does, with a short
window (``--seconds``), and prints its numbers: the program's (the lower
readings), each planted fault's (the family's ``FAULTS``, e.g.
``benchmark/families/resdet3d.py``), and the control's, the reference
computed one precision below the configuration's in the program's place
(the upper readings; in one process over the global batch, also for a cell
of several ranks, whose program and fault runs share one group of ranks).
One JSON line a run, also appended to ``--out``. The benchmark's own runs
never run this.
"""

import os
import sys

if __name__ == "__main__":  # the checkout's root, in place of this script's folder
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark.harness.main import BENCH, cell_files, run_cell  # noqa: E402
from benchmark.harness.ranks import Ranks  # noqa: E402

# a plan of many runs: every rank's process holds its card this long at the most
DEADLINE_S = 3300.0


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _report(args, what, seed, res, t0):
    line = {"cell": args.workload, "run": what, "seed": seed, "correct": res["correct"],
            "readings": res["readings"], "reference_s": res["reference_s"], "units": res["attempted"],
            "metrics": res["metrics"], "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    plan = [("program", s, None) for s in _seeds(args.seeds)]
    plan += [(f, s, f) for f in args.faults.split(",") if f for s in _seeds(args.fault_seeds)]
    runs = [dict(cell=args.workload, seed=s, seconds=args.seconds, trace=False, fault=f) for _, s, f in plan]
    n = int(cell_files(args.workload)["traffic"].get("ranks", 1))
    with Ranks(n if runs else 1, runs, "cuda", BENCH, DEADLINE_S) as group:
        for (what, seed, _), run in zip(plan, runs):
            t0 = time.perf_counter()
            res = run_cell(**run, place=group.place())
            _report(args, what, seed, res, t0)
            torch.cuda.empty_cache()
    for seed in _seeds(args.control_seeds):  # one process, over the global batch
        t0 = time.perf_counter()
        res = run_cell(args.workload, seed, args.seconds, False, control=True)
        _report(args, "control", seed, res, t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
