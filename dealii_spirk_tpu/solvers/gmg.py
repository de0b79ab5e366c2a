"""Geometric multigrid V-cycle with Chebyshev smoothing.

Equivalent of the reference's ``PreconditionerGMG``
(``preconditioner.h:219-501``): global-coarsening level hierarchy,
Chebyshev(5)/point-Jacobi smoothing on every level with CG-estimated
smoothing intervals, and a coarse-grid solve.

Deviations from the reference, by design:

* The coarse solve is an exact dense solve (precomputed inverse of the
  tiny coarsest-level matrix) instead of one Trilinos-ML AMG V-cycle
  (reference ``preconditioner.h:377-399``) — the coarsest tensor grid has
  at most a few hundred DoFs, so a single small matmul is both exact and
  faster than an AMG hierarchy.  This can only *reduce*
  iteration counts.
* The stage-batched ("block") variant is the same code vmapped over the
  leading stage axis — replacing ``MGTransferBlockGlobalCoarsening`` and
  the block smoother (reference ``preconditioner.h:407-446``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.grid import Space
from ..ops.mass_laplace import (
    LevelOps,
    apply_shifted,
    apply_shifted_batched,
    level_ops,
    operator_diagonal,
)
from ..ops.transfer import prolong, restrict
from .chebyshev import chebyshev_apply, estimate_chebyshev_range

SMOOTHER_DEGREE = 5  # reference preconditioner.h:222
SMOOTHING_RANGE = 20.0  # reference preconditioner.h:221
EIG_CG_ITERATIONS = 20  # reference preconditioner.h:223

class GMGData(NamedTuple):
    """Static (tau-independent) multigrid data for one problem (a pytree)."""

    level_ops: tuple[LevelOps, ...]  # coarse -> fine
    prolongs: tuple[jnp.ndarray, ...]  # [l]: level l -> level l+1
    coarse_mass: jnp.ndarray  # dense coarsest-level dim-D mass matrix
    coarse_stiff: jnp.ndarray


class GMGPrec(NamedTuple):
    """Shift-dependent state produced by ``gmg_reinit`` (a pytree)."""

    inv_diags: tuple[jnp.ndarray, ...]
    thetas: tuple[jnp.ndarray, ...]
    deltas: tuple[jnp.ndarray, ...]
    coarse_inv: jnp.ndarray


# levels at or below this DoF count are dropped and solved exactly by the
# dense coarse solve: one small matmul replaces several smoothing chains
# of tiny, launch-bound kernels.  This can only strengthen the
# preconditioner relative to the reference (which coarsens all the way
# to one cell, preconditioner.h:287-339).
COARSE_SIZE_LIMIT = 1024


def _coarse_dense(space: Space, dtype, l0: int) -> tuple[np.ndarray, np.ndarray]:
    lev = space.levels[l0]
    M1, K1 = lev.mass_dense, lev.stiff_dense
    if space.dim == 2:
        M = np.kron(M1, M1)
        K = np.kron(K1, M1) + np.kron(M1, K1)
    else:
        MM = np.kron(M1, M1)
        MK = np.kron(M1, K1) + np.kron(K1, M1)
        M = np.kron(M1, MM)
        K = np.kron(K1, MM) + np.kron(M1, MK)
    return M.astype(dtype), K.astype(dtype)


def build_gmg_data(
    space: Space,
    dtype=jnp.float64,
    with_dense: bool = True,
    coarse_size_limit: int = COARSE_SIZE_LIMIT,
) -> GMGData:
    # coarsest retained level: the largest one still within the dense
    # coarse-solve budget (always keep at least the bottom level, and keep
    # the finest level out of the dense solve when there are >= 2 levels)
    l0 = 0
    for i, lev in enumerate(space.levels):
        if lev.m**space.dim <= coarse_size_limit:
            l0 = i
    if l0 == len(space.levels) - 1 and len(space.levels) > 1:
        l0 -= 1
    cm, ck = _coarse_dense(space, np.float64, l0)
    return GMGData(
        level_ops=tuple(
            level_ops(lev, dtype, with_dense=with_dense)
            for lev in space.levels[l0:]
        ),
        prolongs=tuple(
            jnp.asarray(P, dtype=dtype) for P in space.prolongations[l0:]
        ),
        coarse_mass=jnp.asarray(cm, dtype=dtype),
        coarse_stiff=jnp.asarray(ck, dtype=dtype),
    )


def _make_A(
    ops: LevelOps,
    a,
    b,
    dim: int,
    mode: str,
    batch: bool,
) -> Callable:
    if batch:
        return lambda u: apply_shifted_batched(ops, a, b, u, dim, mode)
    return lambda u: apply_shifted(ops, a, b, u, dim, mode)


def gmg_reinit(
    gmg: GMGData,
    a,
    b,
    dim: int,
    mode: str = "stencil",
    *,
    batch: bool = False,
    n_cg_iterations: int = EIG_CG_ITERATIONS,
    smoothing_range: float = SMOOTHING_RANGE,
) -> GMGPrec:
    """Build the shift-dependent GMG state for the operator a*M + b*K.

    ``a`` is a scalar — or a vector of per-stage shifts when ``batch``
    (the block preconditioner, reference ``main.cc:3150-3178``).  This is
    the analog of ``PreconditionerGMG::reinit`` (reference
    ``preconditioner.h:341-447``): per-level Jacobi diagonals, Chebyshev
    eigenvalue estimation, coarse matrix factorization.
    """
    inv_diags = []
    thetas = []
    deltas = []
    key = jax.random.PRNGKey(42)
    one = jnp.ones(a.shape if batch else (), dtype=gmg.coarse_mass.dtype)
    for lvl, ops in enumerate(gmg.level_ops):
        m = ops.m
        if batch:
            diag = jax.vmap(
                lambda ai: operator_diagonal(ops, ai, b, dim)
            )(a)
        else:
            diag = operator_diagonal(ops, a, b, dim)
        inv_diag = 1.0 / diag
        if lvl == 0:
            # the coarsest level is solved exactly (dense); no smoother
            inv_diags.append(inv_diag)
            thetas.append(one)
            deltas.append(one)
            continue
        shape = (m,) * dim
        rhs = jax.random.uniform(key, shape, dtype=ops.mass_band.dtype)
        if batch:
            rhs = jnp.broadcast_to(rhs, (a.shape[0],) + shape)
        A = _make_A(ops, a, b, dim, mode, batch)
        theta, delta = estimate_chebyshev_range(
            A,
            inv_diag,
            rhs,
            n_cg_iterations=n_cg_iterations,
            smoothing_range=smoothing_range,
            batch=batch,
        )
        inv_diags.append(inv_diag)
        thetas.append(theta)
        deltas.append(delta)

    if batch:
        coarse = (
            a[:, None, None] * gmg.coarse_mass[None] + b * gmg.coarse_stiff
        )
        coarse_inv = jnp.linalg.inv(coarse)
    else:
        coarse_inv = jnp.linalg.inv(a * gmg.coarse_mass + b * gmg.coarse_stiff)

    return GMGPrec(
        inv_diags=tuple(inv_diags),
        thetas=tuple(thetas),
        deltas=tuple(deltas),
        coarse_inv=coarse_inv,
    )


def _coarse_solve(prec: GMGPrec, r, dim: int, batch: bool):
    if batch:
        q = r.shape[0]
        flat = r.reshape(q, -1)
        x = jnp.einsum("qij,qj->qi", prec.coarse_inv, flat)
        return x.reshape(r.shape)
    flat = r.reshape(-1)
    return (prec.coarse_inv @ flat).reshape(r.shape)


def vcycle(
    gmg: GMGData,
    prec: GMGPrec,
    a,
    b,
    r,
    dim: int,
    mode: str = "stencil",
    *,
    batch: bool = False,
    degree: int = SMOOTHER_DEGREE,
):
    """One multigrid V-cycle approximating (a*M + b*K)^-1 r.

    Pre-smoothing from a zero initial guess, residual restriction, coarse
    solve, prolongated correction, post-smoothing — matching deal.II's
    ``Multigrid`` as configured by the reference (one V-cycle used either
    as the inner-CG preconditioner or directly when InnerTolerance == 0,
    reference ``main.cc:1126-1148``).
    """
    n_levels = len(gmg.level_ops)

    def smooth(l, rl, x0=None):
        A = _make_A(gmg.level_ops[l], a, b, dim, mode, batch)
        return chebyshev_apply(
            A,
            prec.inv_diags[l],
            prec.thetas[l],
            prec.deltas[l],
            rl,
            x0=x0,
            degree=degree,
            batch=batch,
        )

    def solve(l, rl):
        if l == 0:
            return _coarse_solve(prec, rl, dim, batch)
        A = _make_A(gmg.level_ops[l], a, b, dim, mode, batch)
        x = smooth(l, rl)
        res = rl - A(x)
        rc = restrict(gmg.prolongs[l - 1], res, dim)
        xc = solve(l - 1, rc)
        x = x + prolong(gmg.prolongs[l - 1], xc, dim)
        return smooth(l, rl, x0=x)

    return solve(n_levels - 1, r)
