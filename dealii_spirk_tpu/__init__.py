"""dealii_spirk_tpu — a JAX stage-parallel implicit Runge-Kutta framework.

A from-scratch JAX/XLA re-design of the capabilities of
peterrum/dealii-spirk (stage-parallel fully implicit Runge-Kutta solvers
for the time-dependent heat equation with optimal multigrid
preconditioners; see arXiv:2209.06700).

Reference parity map (file:line citations point into the reference tree):

* time-integration schemes (``ost``, ``irk``, ``irk_batched``, ``spirk``,
  ``complex_irk``, ``complex_irk_batched``, ``complex_spirk``,
  ``complex_spirk_batched``) — reference ``main.cc:450-2937``
* mass/Laplace operators — reference ``include/operator.h``
* Chebyshev-smoothed geometric multigrid — reference
  ``include/preconditioner.h``
* Butcher / diagonalization tables — reference ``tables/irk_ev.m``

Unlike the reference (deal.II + MPI on CPU clusters), everything here is
built for an accelerator: the uniformly refined hypercube mesh is
represented as a tensor-product grid so every FEM operator is a chain of
separable 1D banded applications that XLA fuses, stages are a batch/mesh
axis instead of MPI rank groups, and distribution happens via
``jax.sharding.Mesh`` + collectives instead of MPI.
"""

import jax

# float64 is required for solver-tolerance parity with the reference
# (OuterTolerance down to 1e-12, see reference scripts/default.json).
# Benchmarks can still request float32 via the Precision config.
jax.config.update("jax_enable_x64", True)

# On GPUs with tensor cores, f32 matmuls default to TF32 (about three
# decimal digits); for a PDE solver chasing 1e-4..1e-12 residual
# reductions every contraction (stage mixing, grid transfer, coarse solve)
# must run at full f32 — reduced-precision operator error stalls Krylov
# convergence (GMRES hits maxiter instead of converging).
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

from . import tables  # noqa: E402,F401
