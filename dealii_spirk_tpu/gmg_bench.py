"""GMG microbenchmark — counterpart of the reference's ``gmg`` executable
(reference ``gmg.cc:56-427``): sweep refinement levels and measure the
cost of GMG-preconditioned CG on ``M + K`` four ways.

Reference modes (``gmg.cc:350-382``) and their realizations here:

1. 1 scalar component                  -> single solve (``scalar``)
2. FESystem with 8 components in 1 op  -> ``fesystem8``: ONE shared scalar
                                          preconditioner (one Chebyshev
                                          eigenvalue estimate, one coarse
                                          factorization — the FESystem op
                                          has a single preconditioner)
                                          broadcast over the component
                                          axis of the batched solve
3. 8 sub-communicators x 1 component   -> ``subgroups8``: component axis
                                          sharded one-per-device
4. batched 8-block op + block GMG      -> ``batched8``: per-component
                                          diagonals/estimates (block GMG);
                                          identical apply graph to mode 2
                                          but distinct setup, both
                                          reported like the reference

Modes that exceed device memory at large refinements report ``oom``
instead of a time — the fit limit is *measured*, not defaulted (the reference sweeps
to refinement 19 on 3072 nodes, gmg.cc:342).

Reports time / iteration like ``gmg.cc:289-291`` (10 timed solves to
reduction 1e-12 after one warmup, ReductionControl(1000, 1e-20, 1e-12)).

Usage: ``python -m dealii_spirk_tpu.gmg_bench [--dim 2|3] [--max-ref N]``
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

from .fem.grid import make_space
from .ops.mass_laplace import apply_shifted
from .solvers.gmg import build_gmg_data, gmg_reinit, vcycle
from .solvers.krylov import pcg
from .utils.compile_cache import enable_compile_cache
from .utils.table import ConvergenceTable

N_REPETITIONS = 10  # gmg.cc:213
N_COMPONENTS = 8  # gmg.cc:350-382


def _bench_mode(
    space, gmg, dim, n_components, dtype, sharded=False, shared_prec=False,
):
    """One benchmark mode.  ``sharded`` distributes the component axis
    over the available devices — the reference's "8 sub-communicators,
    one component each" mode (gmg.cc:362-371).  ``shared_prec`` builds
    ONE scalar preconditioner and broadcasts it over the components —
    the reference's FESystem mode (gmg.cc:356-360), whose single
    operator carries a single Chebyshev estimate/coarse solve."""
    a, b = 1.0, 1.0  # gmg.cc solves the (M + K)-type system
    mode = "stencil"
    # gmg.cc uses ReductionControl(1000, 1e-20, 1e-12); 1e-12 is below f32
    # resolution, so scale the reduction to the dtype
    reltol = 1e-12 if dtype == jnp.float64 else 1e-5
    batch = n_components > 1
    if batch:
        shifts = jnp.ones((n_components,), dtype=dtype)
        if shared_prec:
            scalar_prec = jax.jit(
                lambda: gmg_reinit(gmg, a, b, dim, mode)
            )()
            bcast = lambda x: jnp.broadcast_to(
                x[None], (n_components,) + x.shape
            )
            prec = jax.tree_util.tree_map(bcast, scalar_prec)
        else:
            prec = jax.jit(
                lambda: gmg_reinit(gmg, shifts, b, dim, mode, batch=True)
            )()
    else:
        prec = jax.jit(lambda: gmg_reinit(gmg, a, b, dim, mode))()
    jax.block_until_ready(prec)

    fine = gmg.level_ops[-1]
    key = jax.random.PRNGKey(7)
    shape = ((n_components,) if batch else ()) + space.shape
    rhs = jax.random.normal(key, shape, dtype=dtype)

    constrain = lambda v: v
    if sharded:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        import numpy as _np

        devs = jax.devices()[:n_components]
        mesh = Mesh(_np.array(devs), axis_names=("comp",))
        sharding = NamedSharding(
            mesh, P("comp", *(None,) * len(space.shape))
        )
        constrain = lambda v: jax.lax.with_sharding_constraint(v, sharding)

    if batch:
        from .ops.mass_laplace import apply_shifted_batched

        A = lambda W: constrain(
            apply_shifted_batched(fine, shifts, b, constrain(W), dim, mode)
        )
        M = lambda r, pr: constrain(
            vcycle(gmg, pr, shifts, b, constrain(r), dim, mode, batch=True)
        )
    else:
        A = lambda w: apply_shifted(fine, a, b, w, dim, mode)
        M = lambda r, pr: vcycle(gmg, pr, a, b, r, dim, mode)

    # prec rides as a jit ARGUMENT: as a closure constant its 8-component
    # level diagonals would be hundreds of MB of program body
    solve = jax.jit(
        lambda r, pr: pcg(
            A, r, M=lambda v: M(v, pr), maxiter=1000, abstol=1e-20,
            reltol=reltol, batch=batch,
        )
    )
    res = solve(rhs, prec)  # warmup (gmg.cc:226-239)
    jax.block_until_ready(res.x)
    t0 = time.perf_counter()
    for _ in range(N_REPETITIONS):
        res = solve(rhs, prec)
    jax.block_until_ready(res.x)
    elapsed = (time.perf_counter() - t0) / N_REPETITIONS
    n_it = (
        int(jnp.max(res.n_iterations)) if batch else int(res.n_iterations)
    )
    return elapsed, n_it


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument("--min-ref", type=int, default=3)
    parser.add_argument(
        "--max-ref", type=int, default=None,
        help="default: 9 on a GPU, where the sweep marks the modes that "
        "do not fit the card 'oom' itself (the reference sweeps to 19, "
        "gmg.cc:342); 6 on the CPU (f64 wall time)",
    )
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--precision", default="f64", choices=("f32", "f64"))
    parser.add_argument(
        "--modes", default="",
        help="comma-separated subset of scalar,fesystem8,batched8,"
        "subgroups8 (default: all applicable)",
    )
    args = parser.parse_args(argv)

    enable_compile_cache()
    dtype = jnp.float64 if args.precision == "f64" else jnp.float32
    if args.max_ref is None:
        args.max_ref = 9 if jax.default_backend() == "gpu" else 6
    table = ConvergenceTable()
    for ref in range(args.min_ref, args.max_ref + 1):
        space = make_space(args.dim, args.degree, ref)
        gmg = build_gmg_data(space, dtype=dtype, with_dense=False)
        row = {"refinement": ref, "n_dofs": space.n_dofs}
        modes = [
            ("scalar", 1, False, False),
            ("fesystem8", N_COMPONENTS, False, True),
            ("batched8", N_COMPONENTS, False, False),
        ]
        if len(jax.devices()) >= N_COMPONENTS:
            # the reference's "8 sub-communicators x 1 component" mode
            # (gmg.cc:362-371): component axis sharded one-per-device
            modes.append(("subgroups8", N_COMPONENTS, True, False))
        if args.modes:
            keep = set(args.modes.split(","))
            modes = [m for m in modes if m[0] in keep]
        for label, nc, sharded, shared in modes:
            try:
                elapsed, n_it = _bench_mode(
                    space, gmg, args.dim, nc, dtype, sharded=sharded,
                    shared_prec=shared,
                )
            except Exception as e:  # measured limit, not a default
                msg = str(e)
                if "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg:
                    mark = "oom"  # measured device-memory boundary
                else:
                    raise
                # print the actual first line next to the mark so a
                # mislabeled failure is diagnosable from the table output
                # (substring sniffing can misclassify)
                first = msg.splitlines()[0] if msg else type(e).__name__
                print(f"# {label} r{ref}: {mark} ({first[:160]})")
                row[f"t_{label}"] = mark
                row[f"it_{label}"] = 0
                row[f"t_per_it_{label}"] = mark
                continue
            row[f"t_{label}"] = elapsed
            row[f"it_{label}"] = n_it
            row[f"t_per_it_{label}"] = elapsed / max(n_it, 1)
        for k, v in row.items():
            table.add_value(k, v)
            if k.startswith("t") and isinstance(v, float):
                table.set_scientific(k, True)
        table.commit_row()
        print(json.dumps({k: (float(v) if isinstance(v, float) else v)
                          for k, v in row.items()}))
    print()
    print(table.to_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
