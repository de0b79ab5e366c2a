#!/usr/bin/env python3
"""Record the reference's scaling axes on virtual CPU device meshes.

Execution of the reference's strong/weak-scaling studies (reference
``scripts/small_scaling.py:27-40`` — MaxRanks ladder over {irk, spirk} —
and ``large_scaling.py:36-46`` — weak scaling over q in {2, 4, 9}) as a
correctness table: each row runs in a child process with an n-device
virtual CPU backend (the same
mechanism as the driver's ``dryrun_multichip``), and the table records
what the reference's studies measure at the scaling limit as their
*correctness* axis: L2 error and outer/inner iteration counts, which
must be INVARIANT in the device count (the mathematics does not know the
mesh shape).  Wall times on a virtual CPU mesh are meaningless and are
deliberately not recorded.

Usage:  python -m scripts.scaling_table [--strong] [--weak] [--out FILE]

Output: one JSON line per row, then a markdown table (recorded in
docs/EXPERIMENTS.md).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scaled-down analogs of the reference's configs (the reference's
# refinement-8 3D grids need a cluster; the invariance claim is
# grid-size independent): q x refinement, 3D, dt 0.1 to T=0.3.
BASE = {
    "FEDegree": 1,
    "NRefinements": 4,
    "TimeStepSize": 0.1,
    "EndTime": 0.3,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-8,
    "DoOutputParaview": False,
}

# reference small_scaling.py:27-40: MaxRanks ladder x {irk, spirk}
STRONG_LADDER = (1, 2, 4, 8)
# reference large_scaling.py:36-46: q in {2, 4, 9}, refinement growing
# with q (theirs: (2,7), (4,8), (9,9) — shifted down 4 refinements here)
WEAK_ROWS = ((2, 3), (4, 4), (9, 5))


def child(cfg_json: str, dim: int) -> None:
    """Run one config on this process's (virtual) device set; print one
    JSON result line."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from dealii_spirk_tpu.config import Parameters
    from dealii_spirk_tpu.runner import run_config

    cfg = json.loads(cfg_json)
    params = Parameters.from_dict(cfg, dim=dim)
    out = run_config(params, verbose=False)
    scheme = out["scheme"]
    mesh = getattr(scheme, "mesh", None)
    print(
        "RESULT "
        + json.dumps(
            {
                "scheme": cfg["TimeIntegrationScheme"],
                "q": cfg["IRKStages"],
                "refinement": cfg["NRefinements"],
                "max_ranks": cfg.get("MaxRanks", 0),
                "n_devices": len(jax.devices()),
                "mesh": dict(mesh.shape) if mesh is not None else None,
                "error_L2": out["error_L2"],
                "error_Linf": out["error_Linf"],
                "n_outer": out["n_outer"],
                "n_inner": out["n_inner"],
                "n_inner_stage": [
                    int(x) for x in scheme.n_inner_stage
                ],
            }
        )
    )


def run_row(n_devices: int, cfg: dict, dim: int = 3) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    env["XLA_FLAGS"] = " ".join(
        flags + [f"--xla_force_host_platform_device_count={n_devices}"]
    )
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from scripts.scaling_table import child\n"
        f"child({json.dumps(json.dumps(cfg))}, {dim})\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
    )
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            row = json.loads(line[len("RESULT "):])
            print(json.dumps(row))
            return row
    raise RuntimeError(
        f"child produced no RESULT (rc={proc.returncode}):\n"
        f"{proc.stdout}\n{proc.stderr}"
    )


def strong_rows() -> list[dict]:
    """MaxRanks ladder on a fixed 8-device pool, {irk, spirk} x q=4 —
    the reference's strong-scaling axis (small_scaling.py:27-40).  The
    spirk mesh shrinks (4,2) -> (4,1) as MaxRanks drops; every quantity
    but the mesh shape must be identical."""
    rows = []
    q = 4
    for scheme in ("irk", "spirk"):
        for max_ranks in STRONG_LADDER:
            if scheme == "spirk" and max_ranks < q:
                continue  # reference asserts >= q ranks (main.cc:3668)
            if scheme == "irk" and max_ranks != 1:
                continue  # sequential oracle: one row
            cfg = {
                **BASE,
                "TimeIntegrationScheme": scheme,
                "IRKStages": q,
                "MaxRanks": max_ranks,
            }
            rows.append(run_row(8, cfg))
    return rows


def weak_rows() -> list[dict]:
    """Weak scaling q in {2, 4, 9} with refinement growing alongside
    (large_scaling.py:36-46); each spirk row runs one-stage-per-device
    on a q-device mesh and is paired with its sequential irk oracle."""
    rows = []
    for q, refinement in WEAK_ROWS:
        cfg = {
            **BASE,
            "IRKStages": q,
            "NRefinements": refinement,
        }
        rows.append(
            run_row(q, {**cfg, "TimeIntegrationScheme": "spirk"})
        )
        rows.append(
            run_row(1, {**cfg, "TimeIntegrationScheme": "irk"})
        )
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = (
        "| scheme | q | ref | MaxRanks | devices | mesh | error_L2 | "
        "n_outer | n_inner |\n|---|---|---|---|---|---|---|---|---|"
    )
    lines = [hdr]
    for r in rows:
        mesh = (
            f"({r['mesh']['stage']},{r['mesh']['space']})"
            if r["mesh"]
            else "—"
        )
        lines.append(
            f"| {r['scheme']} | {r['q']} | {r['refinement']} | "
            f"{r['max_ranks'] or '—'} | {r['n_devices']} | {mesh} | "
            f"{r['error_L2']:.6e} | {r['n_outer']:g} | {r['n_inner']:g} |"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strong", action="store_true")
    ap.add_argument("--weak", action="store_true")
    args = ap.parse_args()
    do_all = not (args.strong or args.weak)

    out = []
    if args.strong or do_all:
        print("# strong scaling (MaxRanks ladder, q=4, refinement 4)")
        strong = strong_rows()
        out.append(("Strong scaling (MaxRanks ladder)", strong))
    if args.weak or do_all:
        print("# weak scaling (q in {2,4,9})")
        weak = weak_rows()
        out.append(("Weak scaling (q in {2,4,9})", weak))
    for title, rows in out:
        print(f"\n## {title}\n")
        print(to_markdown(rows))


if __name__ == "__main__":
    main()
