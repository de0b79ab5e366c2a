"""Time the XLA stencil path's hot operations on one GPU against the
one-pass HBM bound.

Cases (q=4 stage blocks of 255^3 f32 each, 265.3 MB): degree 1 at
refinement 8 and degree 2 at refinement 7.  For each case:

* ``apply``: ``apply_shifted_batched`` (per-stage a_i M + b K, the
  V-cycle's operator apply: 7 one-axis banded sweeps in 3D);
* ``cheb``: one Chebyshev smoother application as the V-cycle's
  pre-smoother calls it (``chebyshev_apply``, degree 5: an init pass and
  4 iterations of one apply plus the Jacobi-scaled three-term update),
  with the finest level's state from ``gmg_reinit``; ``cheb_iter`` is
  its time over 4.  (Iterating the bare iteration feeds its growth
  outside the smoothing range back into itself and overflows.)
* ``copy``: ``y = s * y`` over the same block, what one read and one
  write reach on this card.

Each is timed as the slope of an in-jit ``lax.fori_loop`` between N and
2N repetitions, so dispatch and sync costs cancel.  The bound is one read
and one write of the stage block at the data sheet's 3.35 TB/s.  Also
prints the kernels XLA emits per operation (fusions, library calls and
copies in the GPU-compiled module) and XLA's own bytes-accessed
estimate.

Usage: ``python scripts/stencil_roofline.py [--n N] [--reps R]``; writes
``chiprun_out/stencil_roofline.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from dealii_spirk_tpu.fem.grid import make_space  # noqa: E402
from dealii_spirk_tpu.ops.mass_laplace import apply_shifted_batched  # noqa: E402
from dealii_spirk_tpu.solvers.chebyshev import chebyshev_apply  # noqa: E402
from dealii_spirk_tpu.solvers.gmg import build_gmg_data, gmg_reinit  # noqa: E402
from dealii_spirk_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from dealii_spirk_tpu.utils.gpu import card_lines, device_summary, require_gpu  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
Q = 4
TAU = 0.1
SHIFTS = (16.0, 5.644, 3.162, 2.942)  # q=4 Radau IIA real-diagonalized D
CASES = ((1, 8), (2, 7))  # (degree, refinement): 255^3 per stage


def kernel_sites(hlo: str) -> dict:
    """Kernel call sites in the compiled module, by kind: the entry
    computation plus loop bodies (a loop body's sites run once per trip)."""
    counts = {}
    for op in re.findall(r" (fusion|custom-call|copy|while)\(%", hlo):
        counts[op] = counts.get(op, 0) + 1
    return counts


def loop_slope(step, state, const, n: int, reps: int) -> tuple[float, dict]:
    """Seconds per ``step(state, const)`` from timing ``n`` and ``2n``
    iterations of one jitted fori_loop (best of ``reps``), and the loop
    program's kernel sites; ``const`` rides as an argument, not a program
    constant."""
    run = jax.jit(
        lambda s, c, k: lax.fori_loop(0, k, lambda _i, x: step(x, c), s)
    )
    sites = kernel_sites(run.lower(state, const, n).compile().as_text())
    jax.block_until_ready(run(state, const, n))  # compile + warm up

    def timed(k):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run(state, const, k))
            best = min(best, time.perf_counter() - t0)
        if not all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(out)):
            raise RuntimeError("iterated state is not finite")
        return best

    return (timed(2 * n) - timed(n)) / n, sites


def call_seconds(fn, state, const, n: int) -> float:
    """Seconds per call over ``n`` back-to-back calls of one jitted
    ``fn`` (dispatch gaps included): a cross-check on ``loop_slope``."""
    f = jax.jit(fn)
    jax.block_until_ready(f(state, const))
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(state, const)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def measure(degree: int, refinement: int, n: int, reps: int) -> dict:
    space = make_space(3, degree, refinement)
    gmg = build_gmg_data(space, dtype=jnp.float32, with_dense=False)
    fine = gmg.level_ops[-1]
    shifts = jnp.asarray(SHIFTS, jnp.float32)
    prec = gmg_reinit(gmg, shifts, TAU, 3, batch=True)
    shape = (Q,) + space.shape
    W = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)
    block_bytes = W.nbytes

    def A(u):
        return apply_shifted_batched(fine, shifts, TAU, u, 3)

    def smoother(r, inv_diag):
        return chebyshev_apply(
            A, inv_diag, prec.thetas[-1], prec.deltas[-1], r, degree=5,
            batch=True,
        )

    inv_diag = prec.inv_diags[-1]
    # scale each operation by its dominant eigenvalue (power iteration) so
    # the iterated field neither overflows nor decays into denormals over
    # the 2N + N iterations timed
    def top_eigenvalue(op, const):
        def power(u, c):
            v = op(u, c)
            return v / jnp.sqrt(jnp.sum(v * v))

        u = jax.jit(
            lambda w, c: lax.fori_loop(0, 60, lambda _i, x: power(x, c), w)
        )(W, const)
        lam = float(jnp.sqrt(jnp.sum(op(u, const) ** 2)))
        # the estimate approaches the top eigenvalue from below: a 10%
        # margin makes the iterated field decay slowly instead of grow
        return jnp.asarray(1.0 / (1.1 * lam), jnp.float32)

    scale_a = top_eigenvalue(lambda u, _c: A(u), None)
    scale_s = top_eigenvalue(smoother, inv_diag)

    out = {
        "degree": degree,
        "refinement": refinement,
        "block_shape": list(shape),
        "block_bytes": block_bytes,
        "one_pass_bound_s": 2 * block_bytes / HBM_BYTES_PER_S,
    }
    for name, fn, state, const in (
        ("apply", lambda w, c: c * A(w), W, scale_a),
        ("cheb", lambda w, c: c[0] * smoother(w, c[1]), W, (scale_s, inv_diag)),
        # c = 1 arrives at run time, so XLA cannot fold the multiply away
        ("copy", lambda w, c: c * w, W, jnp.ones((), jnp.float32)),
    ):
        compiled = jax.jit(fn).lower(state, const).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        t, loop_sites = loop_slope(fn, state, const, n, reps)
        out[name] = {
            "seconds": t,
            "over_bound": t / out["one_pass_bound_s"],
            "kernels": kernel_sites(compiled.as_text()),
            "loop_kernels": loop_sites,
            "call_seconds": call_seconds(fn, state, const, 5 * n),
            "xla_bytes_accessed": float(cost.get("bytes accessed", -1.0)),
        }
    out["apply"]["over_copy"] = out["apply"]["seconds"] / out["copy"]["seconds"]
    out["cheb"]["over_copy"] = out["cheb"]["seconds"] / out["copy"]["seconds"]
    out["cheb_iter_seconds"] = out["cheb"]["seconds"] / 4
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=20, help="loop length N")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)

    devices = require_gpu()
    enable_compile_cache()
    cards = card_lines()
    result = {"device": device_summary(devices), "card": cards, "cases": []}
    print(f"device: {result['device']} card: {' | '.join(cards)}")
    for degree, refinement in CASES:
        r = measure(degree, refinement, args.n, args.reps)
        result["cases"].append(r)
        for name in ("apply", "cheb", "copy"):
            m = r[name]
            print(
                f"p={degree} r{refinement} {name}: {m['seconds'] * 1e3:.4f} ms"
                f" = {m['over_bound']:.2f}x the one-pass bound "
                f"({r['one_pass_bound_s'] * 1e3:.4f} ms); kernels "
                f"{m['kernels']} (in the timing loop {m['loop_kernels']}); "
                f"XLA bytes {m['xla_bytes_accessed']:.4g}; back-to-back "
                f"calls {m['call_seconds'] * 1e3:.4f} ms"
            )
        print(
            f"p={degree} r{refinement} cheb_iter (smoother / 4): "
            f"{r['cheb_iter_seconds'] * 1e3:.4f} ms"
        )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "stencil_roofline.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
