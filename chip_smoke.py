"""Smoke test of the SPIRK time step on NVIDIA GPUs.

Drives the normal entry point (``runner.run_config``, what ``python -m
dealii_spirk_tpu`` calls) on the GPU and checks it against the CPU and
against the f64 solve.  Each phase prints one line; any failure raises
and exits non-zero.

1. Device gate: JAX's devices and the card's name and power limit as
   nvidia-smi gives them.  Exits non-zero when the platform is not
   ``gpu``; there is no CPU fallback.
2. GPU vs CPU oracle: irk_batched, q=4, 3D, degree 1, refinement 4, f64,
   on the GPU and on the CPU in this process.  Per-step outer counts and
   per-stage inner counts equal, L2 error within 1e-9 relative.
3. Main path at refinement 8 (255^3 interior DoFs per stage, 67.9M DoFs
   over q=4): the same configuration in f32 for 3 timesteps and in f64
   for 2.  Per-step outer counts equal, L2 error after step 2 within
   ``L2_RTOL_F32`` relative; prints step wall times and compile time.
4. Last line: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

``--four`` runs only the four-card phase: spirk q=4 on a (4, 1) mesh and
complex_spirk_batched q=4 on a (2, 2) mesh against their one-card
sequential siblings at refinement 6 in f64 (outer counts and per-stage
inner vectors equal, L2 within 1e-9), then refinement-8 f32 spirk on the
(4, 1) mesh timed beside one-card irk_batched.

Usage: ``python chip_smoke.py [--four]``
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import numpy as np

from dealii_spirk_tpu.config import Parameters
from dealii_spirk_tpu.runner import run_config
from dealii_spirk_tpu.utils.compile_cache import enable_compile_cache
from dealii_spirk_tpu.utils.gpu import (
    card_lines,
    device_summary,
    require_gpu,
)

# GPU and CPU run the same f64 arithmetic in another summation order
L2_RTOL_ORACLE = 1e-9
# f32 against f64 at OuterTolerance 1e-4: both stop after the same
# Krylov iterations, so their solutions differ by f32 rounding, which the
# stage basis change (cond(T) = 231 at q=4) amplifies.  At refinement 8
# the L2 error is about 1e-4 of the solution, so that rounding shows as
# about 1e-3 of the error (1.4e-3 on an H100); 1e-2 leaves a 7x margin
L2_RTOL_F32 = 1e-2


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four",
        action="store_true",
        help="run only the four-card phase (needs four GPUs)",
    )
    return parser.parse_args(argv)


def config(scheme: str, refinement: int, precision: str, n_steps: int):
    """irk-family q=4, 3D, degree 1, MatrixFree + GMG, InnerTolerance 0,
    OuterTolerance 1e-4, dt 0.1 for ``n_steps`` timesteps."""
    return Parameters.from_dict(
        {
            "FEDegree": 1,
            "NRefinements": refinement,
            "TimeIntegrationScheme": scheme,
            "IRKStages": 4,
            "TimeStepSize": 0.1,
            "EndTime": 0.1 * n_steps,
            "OperatorType": "MatrixFree",
            "BlockPreconditionerType": "GMG",
            "InnerTolerance": 0.0,
            "OuterTolerance": 1e-4,
            "Precision": precision,
            "DoOutputParaview": False,
        },
        dim=3,
    )


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its
    monitoring events."""

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, duration: float, **_kw) -> None:
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


def run(params, clock: CompileClock, mesh=None) -> dict:
    """``run_config`` plus the compile seconds it took."""
    c0 = clock.seconds
    out = run_config(params, mesh=mesh, verbose=False)
    out["compile_seconds"] = clock.seconds - c0
    return out


def check(ok: bool, what: str) -> None:
    """A failed comparison ends the run (not an ``assert``: ``-O`` would
    drop it)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def fmt_seconds(values) -> str:
    return "[" + ", ".join(f"{v:.4f}" for v in values) + "]"


def phase_gate(four: bool) -> tuple[list, str]:
    devices = require_gpu(n_min=4 if four else 1)
    print(f"gate: devices={devices}")
    card = " | ".join(card_lines())
    print(card)
    return devices, card


def phase_oracle(clock: CompileClock, card: str) -> None:
    params = lambda: config("irk_batched", 4, "f64", 3)
    gpu = run(params(), clock)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run(params(), clock)
    inner = [int(x) for x in gpu["scheme"].n_inner_stage]
    inner_cpu = [int(x) for x in cpu["scheme"].n_inner_stage]
    r = rel(gpu["error_L2"], cpu["error_L2"])
    print(
        f"oracle r4 f64 GPU vs CPU: outer/step {gpu['outer_per_step']} vs "
        f"{cpu['outer_per_step']}, inner/stage {inner} vs {inner_cpu}, "
        f"L2 {gpu['error_L2']:.12e} vs {cpu['error_L2']:.12e} "
        f"(rel {r:.2e}, limit {L2_RTOL_ORACLE:g})"
    )
    check(
        gpu["outer_per_step"] == cpu["outer_per_step"], "outer/step GPU == CPU"
    )
    check(inner == inner_cpu, "inner/stage GPU == CPU")
    check(r < L2_RTOL_ORACLE, "L2 GPU vs CPU")


def phase_main(clock: CompileClock, card: str) -> None:
    f32 = run(config("irk_batched", 8, "f32", 3), clock)
    f64 = run(config("irk_batched", 8, "f64", 2), clock)
    n = len(f64["outer_per_step"])
    # errors[k] is the L2/Linf pair after step k
    e32, e64 = f32["errors"][n][0], f64["errors"][n][0]
    r = rel(e32, e64)
    print(
        f"main r8 irk_batched q=4: outer/step f32 {f32['outer_per_step']} "
        f"f64 {f64['outer_per_step']}; L2 after step {n} f32 {e32:.6e} "
        f"f64 {e64:.6e} (rel {r:.2e}, limit {L2_RTOL_F32:g}); step seconds "
        f"f32 {fmt_seconds(f32['step_seconds'])} "
        f"f64 {fmt_seconds(f64['step_seconds'])}; compile seconds "
        f"f32 {f32['compile_seconds']:.1f} f64 "
        f"{f64['compile_seconds']:.1f}; card {card}"
    )
    check(
        f32["outer_per_step"][:n] == f64["outer_per_step"],
        "outer/step f32 == f64",
    )
    check(np.isfinite(e32) and r < L2_RTOL_F32, "L2 f32 vs f64")


def phase_four(clock: CompileClock, card: str) -> None:
    import __graft_entry__ as graft

    devices = jax.devices()[:4]
    both = {"NRefinements": 6}
    graft._dryrun_one("spirk", "irk", 4, 4, 4, devices, both=both)
    graft._dryrun_one(
        "complex_spirk_batched", "complex_irk_batched", 4, 2, 4, devices,
        both=both,
    )

    from dealii_spirk_tpu.parallel.mesh import make_mesh

    par = run(
        config("spirk", 8, "f32", 3), clock, mesh=make_mesh(4, devices=devices)
    )
    seq = run(config("irk_batched", 8, "f32", 3), clock)
    print(
        f"four r8 f32: spirk (4, 1) step seconds "
        f"{fmt_seconds(par['step_seconds'])} outer/step "
        f"{par['outer_per_step']}; irk_batched one card step seconds "
        f"{fmt_seconds(seq['step_seconds'])} outer/step "
        f"{seq['outer_per_step']}; card {card}"
    )


def phases(args: argparse.Namespace) -> tuple:
    if args.four:
        return (phase_four,)
    return (phase_oracle, phase_main)


def final_line(devices) -> str:
    return json.dumps({"ok": True, "device": device_summary(devices)})


def main(argv=None) -> int:
    args = parse_args(argv)
    devices, card = phase_gate(args.four)
    enable_compile_cache()
    clock = CompileClock()
    for phase in phases(args):
        phase(clock, card)
    print(final_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
