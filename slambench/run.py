#!/usr/bin/env python3
"""Run one cell of the benchmark of ``mageslam_tpu_torch`` once.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``slambench/configs/<name>.json``) and a traffic mix
(``slambench/traffic/<name>.json``).  Progress and the check's numbers go
to standard error; the last line of standard output is the result object.
With ``--trace 0`` it holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``slambench/metrics/<name>.py``).
Exits 2 without a card, 3 if JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# host threads of a real-time process, fixed before torch is imported
THREADS = 2
INTEROP_THREADS = 1


def fix_environment() -> None:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "slambench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    fix_environment()
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(INTEROP_THREADS)
    from slambench import harness
    spec = harness.cell_spec(harness.manifest(), args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_start=T_START, spec=spec)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
