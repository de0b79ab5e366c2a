#!/usr/bin/env python3
"""Generate run scripts for a sweep directory.

Counterpart of the reference's SLURM job-file generators
(``experiments-skx/large-scaling-create-job-files.py`` — which emit
``mpirun -np <48*nodes> ../irk-3D input_*.json`` job files): emits one
shell script per virtual device count, running the whole input sweep on a
CPU mesh of that size, and ``run_gpu.sh``, which runs it in ONE process
on the GPUs (a second JAX process on a card would find its memory taken).
"""

from __future__ import annotations

import argparse
import glob
import os
import stat

TEMPLATE_CPU = """#!/bin/sh
# {n} virtual devices (the reference's mpirun -np {n} analog)
JAX_PLATFORMS=cpu \\
XLA_FLAGS=--xla_force_host_platform_device_count={n} \\
python -m dealii_spirk_tpu --dim {dim} {inputs}
"""

TEMPLATE_GPU = """#!/bin/sh
# one JAX process for the whole sweep (compile cache: see
# dealii_spirk_tpu/utils/compile_cache.py)
python -m dealii_spirk_tpu --dim {dim} {inputs}
"""


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument("--sweep-dir", default=".")
    parser.add_argument(
        "--devices", type=int, nargs="+", default=[1, 2, 4, 8]
    )
    args = parser.parse_args()

    inputs = sorted(glob.glob(os.path.join(args.sweep_dir, "input_*.json")))
    if not inputs:
        raise SystemExit(f"no input_*.json in {args.sweep_dir}")
    joined = " ".join(inputs)

    def emit(path: str, content: str) -> None:
        with open(path, "w") as f:
            f.write(content)
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        print("wrote", path)

    for n in args.devices:
        emit(
            os.path.join(args.sweep_dir, f"run-{n:04d}.sh"),
            TEMPLATE_CPU.format(n=n, dim=args.dim, inputs=joined),
        )
    emit(
        os.path.join(args.sweep_dir, "run_gpu.sh"),
        TEMPLATE_GPU.format(dim=args.dim, inputs=joined),
    )


if __name__ == "__main__":
    main()
