"""Read a cell's comparison on many seeds, and its control, in one process.

    python benchmark/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 \\
        [--control] [--trace 1] [--flags "--clips_per_batch 8" --flags "..."]

Each (flags, seed) pair is one run of :func:`benchmark.harness.cell.run_cell`,
printed as one JSON line with ``seed``, ``flags`` and ``control`` added. Set-up
is paid once: later runs in the process find the kernels built and cuDNN's
plans timed, so their ``setup_s`` is not a cell's set-up. This is how the
sweeps and the limits in ``benchmark/limits/`` were read (``PERF.md``); a
cell's measured runs never use it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--flags", action="append", default=None)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness.cell import Options, RunFailed, run_cell

    rc = 0
    for flags in args.flags or [""]:
        for seed in args.seeds:
            try:
                result = run_cell(Options(workload=args.workload, seed=seed,
                                          seconds=args.seconds, trace=bool(args.trace),
                                          control=args.control, dry_run=args.dry_run,
                                          extra_flags=tuple(flags.split())))
            except RunFailed as e:
                print(json.dumps({"seed": seed, "flags": flags, "error": str(e)}), flush=True)
                rc = 1
                continue
            print(json.dumps({"seed": seed, "flags": flags, "control": args.control,
                              **result}, default=str), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
