"""Algebraic multigrid (plain aggregation) — ``BlockPreconditionerType: "AMG"``.

Counterpart of the reference's ``PreconditionerAMG``
(``preconditioner.h:176-215``, a TrilinosWrappers::PreconditionAMG with ML
defaults).  Trilinos is not available to JAX, so this is a genuine algebraic
hierarchy built from the *matrix entries* instead of the mesh geometry:

* 1D aggregation: pairs of neighboring unknowns form aggregates with a
  piecewise-constant tentative prolongator (plain / unsmoothed
  aggregation — ML's "aggregation without smoothing" mode);
* Galerkin coarse operators ``P^T A P``.  The Kronecker structure of
  ``a M + b K`` makes the per-axis products EXACT: with ``P = P1 (x) ...
  (x) P1`` the coarse operator stays in the same separable family with
  coarse 1D matrices ``M1c = P1^T M1 P1``, ``K1c = P1^T K1 P1`` — so the
  whole existing V-cycle/smoothing machinery (``solvers/gmg.py``) runs
  unchanged on the algebraic hierarchy;
* Chebyshev(5)/point-Jacobi smoothing and the exact dense coarse solve,
  exactly as the GMG configuration (the reference's AMG uses its own ML
  smoothers; smoother parity is not meaningful across libraries and the
  deviation is documented in PARITY.md).

Iteration counts are those of plain-aggregation AMG — noticeably higher
than geometric multigrid (aggregation coarsening halves resolution with
piecewise-constant interpolation), which is exactly the qualitative
behavior the reference observes between its AMG and GMG options.
"""

from __future__ import annotations

import numpy as np

from ..fem.grid import Space
from ..ops.mass_laplace import LevelOps
from .gmg import COARSE_SIZE_LIMIT, GMGData

import jax.numpy as jnp


def aggregation_prolongator(m: int) -> np.ndarray:
    """Piecewise-constant tentative prolongator: aggregates {2i, 2i+1}
    (the last aggregate keeps the remainder).  Shape (m, ceil(m/2))."""
    mc = (m + 1) // 2
    P = np.zeros((m, mc))
    for i in range(m):
        P[i, min(i // 2, mc - 1)] = 1.0
    return P


def dense_to_band(A: np.ndarray, p: int) -> np.ndarray:
    """Band storage ``band[p+k, i] = A[i, i+k]`` (inverse of
    ``fem.assembly.band_to_dense``); raises if A has entries outside the
    band (the Galerkin products of aggregation stay within the fine
    bandwidth: |I-J| <= (p+1)/2 <= p)."""
    m = A.shape[0]
    band = np.zeros((2 * p + 1, m))
    for k in range(-p, p + 1):
        for i in range(m):
            j = i + k
            if 0 <= j < m:
                band[p + k, i] = A[i, j]
    from ..fem.assembly import band_to_dense

    if not np.allclose(band_to_dense(band), A, atol=1e-13 * max(1.0, np.abs(A).max())):
        raise ValueError("matrix entries outside the band")
    return band


def build_amg_data(
    space: Space,
    dtype=jnp.float64,
    with_dense: bool = True,
    coarse_size_limit: int = COARSE_SIZE_LIMIT,
) -> GMGData:
    """Algebraic (aggregation) level hierarchy in the same ``GMGData``
    container the geometric builder produces — drop-in for ``vcycle`` /
    ``gmg_reinit``."""
    fine = space.levels[-1]
    p = fine.degree
    mats = [(fine.mass_dense, fine.stiff_dense)]
    prolongs: list[np.ndarray] = []
    # coarsen algebraically until the dense coarse solve takes over
    while (
        mats[0][0].shape[0] ** space.dim > coarse_size_limit
        and mats[0][0].shape[0] > 2
    ):
        M1, K1 = mats[0]
        P = aggregation_prolongator(M1.shape[0])
        mats.insert(0, (P.T @ M1 @ P, P.T @ K1 @ P))
        prolongs.insert(0, P)

    def ops_for(M1: np.ndarray, K1: np.ndarray) -> LevelOps:
        mb = dense_to_band(M1, p)
        kb = dense_to_band(K1, p)
        return LevelOps(
            mass_band=jnp.asarray(mb, dtype=dtype),
            stiff_band=jnp.asarray(kb, dtype=dtype),
            mass_dense=jnp.asarray(M1, dtype=dtype) if with_dense else None,
            stiff_dense=jnp.asarray(K1, dtype=dtype) if with_dense else None,
            mass_diag=jnp.asarray(np.diag(M1).copy(), dtype=dtype),
            stiff_diag=jnp.asarray(np.diag(K1).copy(), dtype=dtype),
        )

    M0, K0 = mats[0]
    if space.dim == 2:
        cm = np.kron(M0, M0)
        ck = np.kron(K0, M0) + np.kron(M0, K0)
    else:
        MM = np.kron(M0, M0)
        MK = np.kron(M0, K0) + np.kron(K0, M0)
        cm = np.kron(M0, MM)
        ck = np.kron(K0, MM) + np.kron(M0, MK)

    return GMGData(
        level_ops=tuple(ops_for(M1, K1) for M1, K1 in mats),
        prolongs=tuple(jnp.asarray(P, dtype=dtype) for P in prolongs),
        coarse_mass=jnp.asarray(cm, dtype=dtype),
        coarse_stiff=jnp.asarray(ck, dtype=dtype),
    )
