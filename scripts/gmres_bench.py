"""Microbench: GMRES orthogonalization on the GPU — MGS vs CGS at the
huge-grid compact basis.

Batched bench-shaped fields with a near-trivial but ill-conditioned
operator (diagonal spectrum over 4 decades + a roll coupling), tolerance
unreachable inside ``maxiter`` — so every run executes exactly
``maxiter`` Krylov iterations and the measured time is the loop
machinery: basis writes, orthogonalization passes, Givens/carry updates.

Timing: per-iteration cost is the SLOPE between two maxiter values of the
same jitted program — fixed costs (dispatch, device->host pulls, restart
recomputes amortized equally) cancel.

Usage: python -m scripts.gmres_bench [m ...]    (default: 127 255)
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp

from dealii_spirk_tpu.solvers.krylov import COMPACT_BASIS, gmres

Q = 4


def solve_time(A, b, orthog: str, maxiter: int, restart: int) -> float:
    fn = jax.jit(
        lambda bb: gmres(
            A,
            bb,
            maxiter=maxiter,
            abstol=1e-30,
            reltol=1e-14,  # unreachable in f32: full maxiter always runs
            restart=restart,
            batch=True,
            orthog=orthog,
            adaptive=0,
        )
    )
    res = fn(b)
    iters = [int(i) for i in res.n_iterations]
    assert iters == [maxiter] * b.shape[0], iters  # fixed-work contract
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = fn(b)
        float(jnp.sum(res.x))  # tiny pull forces true completion
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    sizes = [int(s) for s in sys.argv[1:]] or [127, 255]
    R = COMPACT_BASIS
    print(
        f"device: {jax.devices()[0]}  (q={Q}, f32, restart={R}, "
        f"slope maxiter {2 * R}->{6 * R})"
    )
    for m in sizes:
        shape = (Q, m, m, m)
        b = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)
        # 4-decade spectrum: GMRES(12) cannot reach 1e-14 -> fixed work
        expo = jax.random.uniform(
            jax.random.PRNGKey(1), shape, jnp.float32, 0.0, 4.0
        )
        scale = 10.0**expo

        def A(v):
            return scale * v + 0.3 * jnp.roll(v, 1, axis=-1)

        gb = b.size * 4 / 1e9
        for orthog in ("mgs", "cgs"):
            t_lo = solve_time(A, b, orthog, 2 * R, R)
            t_hi = solve_time(A, b, orthog, 6 * R, R)
            per_it = (t_hi - t_lo) / (4 * R)
            print(
                f"m={m} ({gb * 1e3 / Q:5.0f} MB/vec) {orthog}: "
                f"{per_it * 1e3:7.3f} ms/iter "
                f"(~{per_it / (gb / 819.0):4.1f} basis passes)"
            )


if __name__ == "__main__":
    main()
