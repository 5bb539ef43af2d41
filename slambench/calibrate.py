#!/usr/bin/env python3
"""Readings that the check's limits are set from, in one process.

    python3 slambench/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control bf16|tf32 --control-seeds <n> ...] \
        [--out <file.json>]

For each seed of ``--seeds`` one run of the cell as ``run.py`` makes it,
with the program's outputs compared (the lower readings); for each of
``--control-seeds`` one run with the plain reference, in the lower
precision ``--control``, in the program's place (the upper readings).
The benchmark's own runs never run the control.  Each line of standard
output is one run's checks; ``--out`` keeps them all as JSON.
"""

import json
import sys
import time

from run import INTEROP_THREADS, THREADS, fix_environment


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", choices=("bf16", "tf32"), default="bf16")
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    fix_environment()
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(INTEROP_THREADS)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    from slambench import harness
    spec = harness.cell_spec(harness.manifest(), args.workload)
    rows = []
    for control, seeds in ((None, args.seeds),
                           (args.control, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   spec=spec, control=control)
            row = dict(workload=args.workload, seed=seed, control=control,
                       attempted=out["attempted"], failed=out["failed"],
                       metrics={k: v["value"]
                                for k, v in out["metrics"].items()},
                       checks={k: v["value"]
                               for k, v in out["checks"].items()},
                       seconds=time.perf_counter() - t0)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
