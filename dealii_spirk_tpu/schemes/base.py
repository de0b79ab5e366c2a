"""Shared scheme machinery: statistics, timers, preconditioner caching.

Mirrors ``TimeIntegrationSchemes::Interface`` + ``IRKBase`` (reference
``main.cc:455-764``): each scheme exposes ``solve_step`` and
``get_statistics``; phase timers and iteration counters reset after the
first timestep (preconditioner setup exclusion, reference
``main.cc:971-973``) and statistics are normalized per timestep.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Parameters
from ..problem import HeatProblem
from ..solvers.gmg import build_gmg_data
from ..utils.timer import PhaseTimers


class SchemeBase:
    def __init__(self, problem: HeatProblem, params: Parameters):
        self.problem = problem
        self.params = params
        self.dim = problem.space.dim
        self.mode = params.operator_mode
        self.dtype = problem.dtype
        if params.block_preconditioner_type == "AMG":
            # algebraic (plain-aggregation) hierarchy, reference
            # PreconditionerAMG (preconditioner.h:176-215); same GMGData
            # container, so the V-cycle machinery is shared
            from ..solvers.amg import build_amg_data

            self.gmg = build_amg_data(
                problem.space,
                dtype=self.dtype,
                with_dense=(self.mode == "dense"),
            )
        else:
            self.gmg = build_gmg_data(
                problem.space,
                dtype=self.dtype,
                with_dense=(self.mode == "dense"),
            )
        self.fine = self.gmg.level_ops[-1]
        self.timers = PhaseTimers()
        self.n_outer = 0.0
        self.n_inner = 0.0
        # per-stage (or per-pair) inner counts for per-stage time
        # attribution (reference main.cc:810-813); schemes accumulate
        import numpy as _np

        self.n_inner_stage = _np.zeros(getattr(params, "irk_stages", 1))
        # outer iterations of every step, first included (the totals
        # above exclude it, like the reference's statistics)
        self.outer_per_step: list[int] = []
        self._tau_cached: float | None = None
        self._prec = None

    # -- preconditioner lifecycle -------------------------------------------
    def _reinit(self, tau: float):
        """Subclasses: build the tau-dependent preconditioner state."""
        raise NotImplementedError

    def prec_state(self, tau: float):
        """Lazily rebuild on time-step change (reference main.cc:823-851)."""
        if self._prec is None or self._tau_cached != tau:
            self._prec = self._reinit(tau)
            self._tau_cached = tau
        return self._prec

    # -- statistics ----------------------------------------------------------
    def clear_statistics(self) -> None:
        self.timers.clear()
        self.n_outer = 0.0
        self.n_inner = 0.0
        self.n_inner_stage = self.n_inner_stage * 0

    def after_step(self, timestep_number: int, n_outer: int) -> None:
        self.outer_per_step.append(n_outer)
        if timestep_number == 1:
            self.clear_statistics()

    def get_statistics(self, table, scaling_factor: float = 1.0) -> None:
        s = max(scaling_factor, 1.0)
        for col, val in (
            ("n_outer", self.n_outer / s),
            ("n_inner", self.n_inner / s),
        ):
            # single-host run: min == avg == max (the reference reports the
            # spread over MPI ranks, main.cc:692-704)
            for suffix in ("min", "avg", "max"):
                table.add_value(f"{col}_{suffix}", round(val, 2))
        t = self.timers.seconds
        for col, key in (
            ("t", "total"),
            ("t_rhs", "rhs"),
            ("t_solver", "outer_solver"),
            ("t_update", "solution_update"),
            ("t_vmult", "system_vmult"),
            ("t_prec_bc", "preconditioner_bc"),
            ("t_prec_solver", "preconditioner_solver"),
        ):
            table.add_value(col, t[key] / s)
            table.set_scientific(col, True)

    def add_per_stage_times(
        self, table, scaling_factor: float, n_lanes: int
    ) -> None:
        """t_prec_solver_0..9 (reference ``main.cc:810-813``): per-stage
        (or per-conjugate-pair) share of the measured preconditioner-solve
        time, attributed by the in-graph per-lane iteration counters —
        the stage solves run fused inside one compiled program, so the
        counters are the per-lane work measurement.  With InnerTolerance 0
        every lane does exactly one V-cycle and the true split is uniform."""
        import numpy as np

        s = max(scaling_factor, 1.0)
        total = self.timers.seconds["preconditioner_solver"] / s
        counts = np.asarray(self.n_inner_stage, dtype=float)
        if counts.sum() > 0:
            shares = counts / counts.sum()
        else:
            shares = np.zeros_like(counts)
            shares[:n_lanes] = 1.0 / max(n_lanes, 1)
        for i in range(10):
            v = float(total * shares[i]) if i < len(shares) else 0.0
            table.add_value(f"t_prec_solver_{i}", v)
            table.set_scientific(f"t_prec_solver_{i}", True)

    # -- interface -----------------------------------------------------------
    def solve_step(self, u, timestep_number: int, t: float, tau: float):
        raise NotImplementedError

    def profile_phases(self, tau: float, n_steps: int) -> None:
        """Fill the t_vmult / t_prec_* timers by replaying the solver
        pieces and scaling by the recorded application counts (the
        reference measures these inside its loops, main.cc:998-1173; here
        they live in one compiled program).  No-op unless the scheme
        exposes replay pieces."""
        import time as _time

        import jax

        pieces = getattr(self, "vmult_piece", None)
        if pieces is None:
            return
        prec = self.prec_state(tau)
        q = self.q
        shape = (q,) + self.problem.space.shape
        import jax.numpy as jnp

        W = jnp.ones(shape, dtype=self.dtype)
        tau_ = jnp.asarray(tau, dtype=self.dtype)

        def timed(fn, *args, reps=5):
            f = jax.jit(fn)
            out = f(*args)
            jax.block_until_ready(out)
            t0 = _time.perf_counter()
            for _ in range(reps):
                out = f(*args)
            jax.block_until_ready(out)
            return (_time.perf_counter() - t0) / reps

        t_vmult = timed(lambda w: self.vmult_piece(w, tau_), W)
        t_bc = timed(self.prec_bc_piece, W)
        t_ps = timed(lambda w: self.prec_solver_piece(w, prec, tau_), W)

        steps = max(n_steps, 1)
        # exact structural counts of the left-preconditioned GMRES cycle
        # (solvers/krylov.py): with x0 = 0 the system vmult runs once per
        # outer iteration, the preconditioner once per iteration plus the
        # initial M(b) residual; a restart boundary would add one of each
        # but production solves converge inside the first cycle (the
        # escalation guard in schemes/irk.py warns loudly if not)
        n_out = self.n_outer / steps
        self.timers.seconds["system_vmult"] = t_vmult * n_out * steps
        self.timers.seconds["preconditioner_bc"] = t_bc * (n_out + 1) * steps
        self.timers.seconds["preconditioner_solver"] = (
            t_ps * (n_out + 1) * steps
        )


def stage_times_factor(c_vec, t, tau, dim):
    """Per-stage forcing time factors g(t + (c_i - 1) tau) (reference
    ``main.cc:867-869``)."""
    from ..fem.functions import rhs_time_factor

    return rhs_time_factor(t + (c_vec - 1.0) * tau, dim)


def stage_mix(mat, W):
    """Dense stage mixing ``out_i = sum_j mat[i, j] W_j`` — the reference's
    basis change (ring rotation in SPIRK, reference ``main.cc:1443-1534``)
    as a tiny matmul over the stage axis (reshaped to a plain 2D GEMM so
    XLA does not materialize transposed layouts)."""
    q = W.shape[0]
    out = mat @ W.reshape(q, -1)
    return out.reshape((mat.shape[0],) + W.shape[1:])
