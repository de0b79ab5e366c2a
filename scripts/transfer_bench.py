"""Microbench: grid-transfer formulations on the GPU (layout-copy hunt).

Times prolong+restrict round trips at the bench's fine level
(stage-batched, (4, 63^3) -> (4, 127^3) -> (4, 63^3)) for three
formulations of the per-axis dense apply:

  v0  moveaxis -> matmul(u, P^T) -> moveaxis
  v1  dot_general contracting the axis directly, moveaxis(0, axis)
      (the current ``ops/banded.py::apply_dense_1d``)
  v2  cycle: always contract the last axis, rotate spatial axes

Not part of the test suite — a perf-engineering tool.
Usage: python -u scripts/transfer_bench.py
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, ".")


def v0_apply(mat, u, axis):
    u_moved = jnp.moveaxis(u, axis, -1)
    out = jnp.matmul(u_moved, mat.T, precision="highest")
    return jnp.moveaxis(out, -1, axis)


def v1_apply(mat, u, axis):
    axis = axis % u.ndim
    out = lax.dot_general(
        mat, u, (((1,), (axis,)), ((), ())), precision="highest"
    )
    return jnp.moveaxis(out, 0, axis)


def make_roundtrip(apply_fn, dim):
    def prolong(P, u):
        for ax in range(u.ndim - dim, u.ndim):
            u = apply_fn(P, u, ax)
        return u

    def restrict(P, u):
        for ax in range(u.ndim - dim, u.ndim):
            u = apply_fn(P.T, u, ax)
        return u

    return lambda P, u: restrict(P, prolong(P, u))


def v2_roundtrip(P, u, dim=3):
    # contract last axis, then rotate the spatial block so the next axis
    # becomes last; after `dim` rounds the order is restored.
    def sweep(mat, u):
        for _ in range(dim):
            u = jnp.matmul(u, mat.T, precision="highest")
            # rotate spatial axes: (..., a, b, c') -> (..., c', a, b)
            perm = list(range(u.ndim))
            sp = perm[-dim:]
            perm[-dim:] = [sp[-1]] + sp[:-1]
            u = jnp.transpose(u, perm)
        return u

    return sweep(P.T, sweep(P, u))


def time_fn(fn, P, u, n=50):
    @jax.jit
    def loop(u0):
        def body(_, u):
            w = fn(P, u)
            return w / (1.0 + 1e-30)  # keep the chain alive

        return lax.fori_loop(0, n, body, u0)

    r = loop(u)  # compile + warmup
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    r = loop(u)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def main():
    from dealii_spirk_tpu.fem.grid import make_space

    space = make_space(3, 1, 7)  # degree 1, refinement 7 -> 127^3
    P = jnp.asarray(space.prolongations[-1], dtype=jnp.float32)  # (127, 63)
    print(f"P: {P.shape}", file=sys.stderr)
    u = jnp.ones((4, 63, 63, 63), dtype=jnp.float32)

    for name, fn in [
        ("v0 moveaxis+matmul", make_roundtrip(v0_apply, 3)),
        ("v1 dot_general", make_roundtrip(v1_apply, 3)),
        ("v2 cycle", v2_roundtrip),
    ]:
        dt = time_fn(fn, P, u)
        print(f"{name:22s} {dt * 1e6:9.1f} us/roundtrip")
        # correctness vs v0
        ref = make_roundtrip(v0_apply, 3)(P, u)
        got = fn(P, u)
        err = float(jnp.max(jnp.abs(ref - got)))
        print(f"{'':22s} max|diff| = {err:.2e}")


if __name__ == "__main__":
    main()
