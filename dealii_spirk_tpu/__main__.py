"""CLI: ``python -m dealii_spirk_tpu [--dim {2,3}] cfg1.json [cfg2.json ...]``

Replaces the reference's ``irk-2D`` / ``irk-3D`` executables
(``main.cc:3608-3791``): each JSON config runs in sequence, accumulating
one convergence table that is printed after every config and at the end.
"""

from __future__ import annotations

import argparse
import sys

from .config import Parameters
from .runner import run_config
from .utils.table import ConvergenceTable


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dealii_spirk_tpu")
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="capture an XLA/Xprof trace of the run into DIR (the "
        "device-trace analog of the reference's phase timers, "
        "SURVEY.md §5)",
    )
    parser.add_argument(
        "--phase-timers",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="fill the t_vmult / t_prec_* table columns by replaying the "
        "solver pieces and scaling by the in-graph iteration counters "
        "(the reference's in-loop phase timers, main.cc:998-1173); ON by "
        "default — use --no-phase-timers to skip the extra piece compiles",
    )
    parser.add_argument("configs", nargs="+", help="JSON parameter files")
    args = parser.parse_args(argv)

    import contextlib

    import jax

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    profile_cm = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )

    table = ConvergenceTable()
    with profile_cm:
        for path in args.configs:
            params = Parameters.from_json(path, dim=args.dim)
            run_config(params, table, profile_phases=args.phase_timers)
            print()
            print(table.to_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
