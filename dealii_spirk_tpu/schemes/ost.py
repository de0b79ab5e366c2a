"""One-step-theta (Crank–Nicolson) scheme.

Counterpart of ``TimeIntegrationSchemes::OneStepTheta`` (reference
``main.cc:476-595``): theta = 1/2, CG with absolute tolerance
``1e-8 * ||rhs||`` preconditioned by one GMG V-cycle.

Note on signs: this implements the *consistent* theta scheme for
``u_t = laplace(u) + f``,

    (M + theta tau K) u^{n+1}
        = (M - (1 - theta) tau K) u^n + tau [theta F^{n+1} + (1-theta) F^n]

with K the (positive) stiffness matrix.  The reference's OST carries the
opposite sign on both K terms (``main.cc:509`` and ``main.cc:523``), which
is inconsistent with its own IRK formulation (``main.cc:998-1028``); the
manufactured-solution convergence test validates this implementation
independently.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.mass_laplace import apply_shifted
from ..solvers.gmg import gmg_reinit, vcycle
from ..solvers.krylov import pcg
from .base import SchemeBase

THETA = 0.5


class OneStepTheta(SchemeBase):
    def __init__(self, problem, params):
        super().__init__(problem, params)
        gmg, fine = self.gmg, self.fine
        dim, mode = self.dim, self.mode
        problem_rhs = problem.rhs

        def reinit(tau):
            return gmg_reinit(gmg, 1.0, THETA * tau, dim, mode)

        def step(u, t, tau, prec):
            rhs = apply_shifted(fine, 1.0, -(1.0 - THETA) * tau, u, dim, mode)
            rhs = rhs + tau * THETA * problem_rhs(t)
            rhs = rhs + tau * (1.0 - THETA) * problem_rhs(t - tau)

            A = lambda v: apply_shifted(fine, 1.0, THETA * tau, v, dim, mode)
            M = lambda r: vcycle(gmg, prec, 1.0, THETA * tau, r, dim, mode)
            abstol = 1e-8 * jnp.sqrt(jnp.sum(rhs * rhs))
            res = pcg(A, rhs, M=M, x0=u, maxiter=1000, abstol=abstol)
            return res.x, res.n_iterations

        self._reinit_jit = jax.jit(reinit)
        self._step_jit = jax.jit(step)

    def _reinit(self, tau):
        return self._reinit_jit(jnp.asarray(tau, dtype=self.dtype))

    def solve_step(self, u, timestep_number, t, tau):
        prec = self.prec_state(tau)
        targs = (
            jnp.asarray(t, dtype=self.dtype),
            jnp.asarray(tau, dtype=self.dtype),
        )
        with self.timers.phase("total"):
            with self.timers.phase("outer_solver"):
                u, n_it = self._step_jit(u, *targs, prec)
                u.block_until_ready()
        if int(n_it) >= 1000:
            raise RuntimeError("CG did not converge within 1000 iterations")
        self.n_outer += int(n_it)
        self.after_step(timestep_number, int(n_it))
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        # the reference's OST reports no statistics (main.cc:539-546)
        pass
