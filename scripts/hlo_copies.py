"""Diagnostic: count backend-inserted full-field copies in the compiled
solve (GMRES basis writes show up as dynamic-update-slices).

Compiles the bench step and greps the *optimized* HLO for copy/DUS ops on
large buffers, attributing them to the while loops they live in.  Not part
of the test suite — a perf-engineering tool.

Usage:  python -u scripts/hlo_copies.py [refinement]
"""

from __future__ import annotations

import collections
import re
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")


def main() -> None:
    refinement = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    from bench import _build

    params, problem, scheme = _build("irk_batched", refinement)
    tau = params.time_step_size
    prec = scheme._reinit(tau)
    jax.block_until_ready(prec)

    def step(u, t, tau_):
        W_rhs = scheme.rhs_fn(u, t, tau_)
        W, n_outer, _ = scheme.solve_fn(W_rhs, prec, tau_)
        return scheme.update_fn(u, W, tau_), n_outer

    u = problem.initial_condition()
    tau_ = jnp.asarray(tau, dtype=problem.dtype)
    lowered = jax.jit(step).lower(u, tau_, tau_)
    compiled = lowered.compile()
    text = compiled.as_text()
    print(f"optimized HLO: {len(text) / 1e6:.1f} MB", file=sys.stderr)

    # big = full-field sized buffers (>= 1M elements)
    copy_re = re.compile(r"copy\(")
    shape_re = re.compile(r"f32\[([0-9,]+)\]")
    counts = collections.Counter()
    big_lines = []
    for line in text.splitlines():
        stripped = line.strip()
        if "= " not in stripped:
            continue
        m = shape_re.search(stripped.split("= ")[0] + "= ")
        # shape of the produced value is before the op name
        msh = shape_re.search(stripped)
        if not msh:
            continue
        n_elems = 1
        for d in msh.group(1).split(","):
            n_elems *= int(d)
        if n_elems < (1 << 20):
            continue
        if copy_re.search(stripped):
            counts[("copy", msh.group(1))] += 1
            if len(big_lines) < 40:
                big_lines.append(stripped[:200])
        elif "dynamic-update-slice" in stripped and "fusion" not in stripped:
            counts[("dus", msh.group(1))] += 1

    print("\n== big copies / DUS in optimized HLO ==")
    for (kind, shape), n in sorted(counts.items(), key=lambda kv: -kv[1]):
        nbytes = 4
        for d in shape.split(","):
            nbytes *= int(d)
        print(f"  {kind:4s} f32[{shape}]  x{n}   ({nbytes / 1e6:.1f} MB each)")
    print("\n== sample copy lines ==")
    for line in big_lines:
        print(" ", line)


if __name__ == "__main__":
    main()
