"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and a breakdown of the profiled
sub-window. A run that finds fewer CUDA devices than the cell asks for fails
and prints no result. ``--dry-run`` rehearses the cell on the CPU at the tiny
sizes of its files' ``dry_run`` entries (for the tests; never a measurement).
Sweeps and the control's readings go through ``benchmark/calibrate.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness.cell import Options, RunFailed, print_result, run_cell

    try:
        result = run_cell(Options(workload=args.workload, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), dry_run=args.dry_run))
    except RunFailed as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
