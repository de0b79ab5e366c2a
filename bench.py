"""Headline benchmark: stage-batched IRK q=4, 3D heat equation, time per
timestep on one GPU.

Prints the device (platform, kind, count) and the card's name and power
limit as nvidia-smi gives them, then, as the last line, ONE JSON line:
    {"metric": ..., "value": ..., "unit": ..., "device": {...}, ...}

``value`` = seconds per timestep of ``irk_batched`` (MatrixFree operator
on the XLA stencil path, truncated GMG with a dense coarse solve) on the
GPU.  On one device this is the same compiled graph ``spirk`` produces
(the stage mesh axis degenerates), but what executes is irk_batched and
the metric name says so.  The reference publishes no absolute numbers;
cross-checking against it is done via iteration/error parity on the f64
CPU oracle.

Configuration mirrors the canonical runs (q=4, degree 1, 3D, MatrixFree
+ GMG, InnerTolerance 0) in f32.  Exits non-zero, printing no result,
when JAX finds no GPU.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SolveCounts(NamedTuple):
    """Iteration counts accumulated over ALL timed steps (not just the
    final scan step): equal-count A/B oracles must see a shift on ANY
    step, and in the masked per-lane inner counts too."""

    outer: int
    inner: int


def _build(scheme_name: str, refinement: int, degree: int = 1, dim: int = 3):
    from dealii_spirk_tpu.config import Parameters
    from dealii_spirk_tpu.problem import HeatProblem
    from dealii_spirk_tpu.schemes import make_scheme

    params = Parameters.from_dict(
        {
            "FEDegree": degree,
            "NRefinements": refinement,
            "TimeIntegrationScheme": scheme_name,
            "IRKStages": 4,
            "TimeStepSize": 0.1,
            "EndTime": 0.5,
            "OperatorType": "MatrixFree",
            "BlockPreconditionerType": "GMG",
            "InnerTolerance": 0.0,
            "OuterTolerance": 1e-4,
            "Precision": "f32",
        },
        dim=dim,
    )
    problem = HeatProblem(params)
    scheme = make_scheme(problem, params)
    return params, problem, scheme


def _time_scheme(
    scheme_name: str, refinement: int, n_steps: int = 5, degree: int = 1,
    dim: int = 3,
):
    """Per-timestep device time via a TWO-POINT in-graph measurement.

    Each measurement runs N timesteps inside ONE jitted ``lax.scan`` and
    ends with a checksum pull; timing the same program at two different
    N and taking the slope cancels every fixed cost (dispatch, transfer,
    the final sync) and leaves the per-step device time.
    """
    params, problem, scheme = _build(scheme_name, refinement, degree, dim)
    tau = params.time_step_size
    prec = scheme._reinit(tau)
    jax.block_until_ready(prec)
    dtype = problem.dtype
    tau_ = jnp.asarray(tau, dtype=dtype)

    # prec rides as a jit ARGUMENT: embedded as a closure constant its
    # leaves would inflate the program body by hundreds of MB at
    # refinement 8
    def make_runner(n: int):
        @jax.jit
        def run(u, prec):
            def body(carry, k):
                u, n_out, n_in = carry
                t = (k.astype(dtype) + 2.0) * tau_
                W_rhs = scheme.rhs_fn(u, t, tau_)
                W, n_outer, n_inner = scheme.solve_fn(W_rhs, prec, tau_)
                # accumulate across ALL steps (outer and the per-lane
                # inner vector summed): the A/B count oracles compare
                # these totals, so a shift on any step or lane triggers
                n_out = n_out + jnp.asarray(n_outer, jnp.int32)
                # dtype pinned: under x64 jnp.sum(int32) promotes to int64
                # and breaks the scan carry contract
                n_in = n_in + jnp.sum(n_inner, dtype=jnp.int32)
                return (scheme.update_fn(u, W, tau_), n_out, n_in), None

            carry0 = (
                u, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)
            )
            (u, n_out, n_in), _ = jax.lax.scan(
                body, carry0, jnp.arange(n, dtype=jnp.int32)
            )
            return u, n_out, n_in, jnp.sum(u * u)

        return run

    @jax.jit
    def first_step(u, prec):
        W_rhs = scheme.rhs_fn(u, tau_, tau_)
        W, n_outer, _ = scheme.solve_fn(W_rhs, prec, tau_)
        return scheme.update_fn(u, W, tau_), n_outer

    u0, _ = first_step(problem.initial_condition(), prec)
    jax.block_until_ready(u0)

    n_lo, n_hi = 2, 2 + n_steps

    def timed(n):
        run = make_runner(n)
        u, n_out, n_in, chk = run(u0, prec)  # warmup/compile
        c = float(chk)
        if not (c > 0 and c < 1e30):
            raise RuntimeError(f"non-finite solution checksum {c}")
        t0 = time.perf_counter()
        u, n_out, n_in, chk = run(u0, prec)
        c = float(chk)  # 4-byte pull: waits for the device
        counts = SolveCounts(int(n_out), int(n_in))
        return time.perf_counter() - t0, counts, u, n

    t_lo, counts, _u, _ = timed(n_lo)
    t_hi, counts, u, n = timed(n_hi)
    elapsed = (t_hi - t_lo) / (n_hi - n_lo)
    err = problem.errors(u, (n + 1) * tau)
    if not float(err[0]) < 1e-2:
        raise RuntimeError(f"benchmark solution error off: L2={err[0]}")
    return elapsed, counts, problem, err


def main() -> None:
    import sys

    from dealii_spirk_tpu.utils.compile_cache import enable_compile_cache
    from dealii_spirk_tpu.utils.gpu import (
        NoGPUError,
        card_lines,
        device_summary,
        require_gpu,
    )

    try:
        devices = require_gpu()
    except NoGPUError as e:
        sys.exit(f"bench.py measures the GPU: {e}")
    device = device_summary(devices)
    print(f"device: {json.dumps(device)}")
    for line in card_lines():
        print(line)
    enable_compile_cache()

    refinement = 7  # 127^3 interior DoFs per stage, q=4
    t_step, counts, _problem, _err = _time_scheme("irk_batched", refinement)
    print(
        f"irk_batched r{refinement}: {t_step * 1e3:.3f} ms/step "
        f"({counts.outer} outer total)",
        file=sys.stderr,
    )
    if counts.outer <= 0 or counts.outer >= 1000:
        raise RuntimeError("benchmark solver did not converge properly")

    print(
        json.dumps(
            {
                "metric": "irk_batched_q4_3d_r7_step_time",
                "value": t_step,
                "unit": "s/timestep",
                "device": device,
                "n_outer_total": counts.outer,
            }
        )
    )


if __name__ == "__main__":
    main()
