"""Krylov solvers, Chebyshev smoothing and geometric multigrid.

Replacements of the reference's L4 layer
(``include/preconditioner.h``, deal.II SolverCG/SolverGMRES): pure-JAX
iterations under ``lax.while_loop`` with tolerance-based predicates, so a
whole implicit solve stays inside one compiled program.  Batched (masked)
variants run one solver across a leading stage axis — each lane keeps its
own iteration count and freezes once converged, reproducing the reference's
per-stage sequential solves (reference ``main.cc:1122-1154``) in a single
vectorized sweep.
"""

from .krylov import gmres, pcg
from .gcr import gcr
from .chebyshev import chebyshev_apply, estimate_chebyshev_range
from .gmg import GMGData, build_gmg_data, gmg_reinit, vcycle

__all__ = [
    "pcg",
    "gmres",
    "gcr",
    "chebyshev_apply",
    "estimate_chebyshev_range",
    "GMGData",
    "build_gmg_data",
    "gmg_reinit",
    "vcycle",
]
