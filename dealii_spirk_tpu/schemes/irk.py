"""Fully implicit Radau IIA Runge–Kutta with real-diagonalized
preconditioning — the ``irk`` / ``irk_batched`` / ``spirk`` family.

Mathematics (reference ``main.cc:771-1222`` and ``main.cc:1229-1760``):
an s-stage step solves the coupled system

    (A^{-1} (x) M + tau I (x) K) W = (A^{-1} (x) I) R,
    R_i = F(t + (c_i - 1) tau) - K u^n,

by outer GMRES preconditioned with ``T (block-diag solves) T^{-1}`` where
``T diag(D) T^{-1} = L`` is the real diagonalization of the lower-
triangular factor of A^{-1}; each diagonal block ``(d_i M + tau K)`` is
solved by one GMG V-cycle (InnerTolerance = 0) or by CG+GMG.  The update
is ``u += tau sum_i b_i W_i``.

Realization of the three reference execution strategies:

* ``irk``          — stage axis as a vmapped batch dimension; the
  "reduced vmults" trick (reference ``main.cc:1014-1028``) is the natural
  formulation here: q mass + q stiffness applies, then an einsum over the
  tiny stage axis.
* ``irk_batched``  — identical compute graph (the reference's fused
  batched cell loop *is* the vmapped operator here); only the reported
  inner-iteration bookkeeping differs (one block V-cycle counts once,
  reference ``main.cc:1115-1119``).
* ``spirk``        — same code with the stage axis placed on a device-mesh
  axis: the stage-mixing einsums become all-gathers (replacing
  the MPI ring rotation, reference ``main.cc:1443-1534``) and Krylov
  reductions psum over (stage, space) — the ``ReshapedVector`` semantics
  (reference ``main.cc:196-275``) fall out of SPMD automatically.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import irk_tables
from ..ops.mass_laplace import (
    apply_mass_stiffness_batched,
    apply_shifted,
    apply_shifted_batched,
    apply_stiffness,
)
from ..solvers.gmg import gmg_reinit, vcycle
from ..solvers.krylov import COMPACT_BASIS, COMPACT_GRID_DOFS, gmres, pcg
from .base import SchemeBase, stage_mix, stage_times_factor


class IRK(SchemeBase):
    def __init__(self, problem, params, mesh=None):
        super().__init__(problem, params)
        self.mesh = mesh
        q = params.irk_stages
        self.q = q
        tabs = irk_tables(q)
        dt = self.dtype
        A_inv = jnp.asarray(tabs.A_inv, dtype=dt)
        T = jnp.asarray(tabs.T, dtype=dt)
        T_inv = jnp.asarray(tabs.T_inv, dtype=dt)
        b_vec = jnp.asarray(tabs.b, dtype=dt)
        c_vec = jnp.asarray(tabs.c, dtype=dt)
        d_vec = jnp.asarray(tabs.D, dtype=dt)

        gmg, fine = self.gmg, self.fine
        dim, mode = self.dim, self.mode
        inner_tol = params.inner_tolerance
        outer_tol = params.outer_tolerance
        batched = params.is_batched
        # plain `irk` executes its stage solves one after the other like
        # the reference (main.cc:1122-1154); `irk_batched` fuses them into
        # one vmapped block solve and `spirk` runs them concurrently across
        # the stage mesh axis — both map to the batched graph.
        sequential_stages = params.time_integration_scheme == "irk"
        shard = self._shard_stage  # sharding hook (identity off-mesh)

        # stage-mixing strategy (reference §2.3: ring rotation vs direct
        # shared-memory gather): UseSharedMemory=false -> ppermute ring,
        # true -> einsum (all-gather); identical results either way
        if (
            mesh is not None
            and not params.use_sm
            and mesh.shape.get("stage") == q
        ):
            from ..parallel.ring import ring_stage_mix

            mixer = lambda mat, W: ring_stage_mix(mat, W, mesh)
        else:
            mixer = stage_mix

        shifted_b = lambda di, Wi, tau: apply_shifted_batched(
            fine, di, tau, Wi, dim, mode
        )

        spatial = (fine.m,) * dim
        # compact fixed basis at huge grids (see solve_fn): if a solve
        # ever exceeds it, a restart fires where deal.II's 30-vector
        # default would not — make that parity divergence loud.
        # ONE evaluation of the huge-grid predicate: the escalation
        # warning, the restart/adaptive choice and the shared-ops mode
        # must flip together (krylov.COMPACT_GRID_DOFS)
        compact = int(np.prod(spatial)) > COMPACT_GRID_DOFS
        self._compact_restart = COMPACT_BASIS if compact else 0

        def reinit(tau):
            return gmg_reinit(gmg, d_vec, tau, dim, mode, batch=True)

        def rhs_fn(u, t, tau):
            tf = stage_times_factor(c_vec, t, tau, dim).astype(dt)
            # stage_load keeps the m^dim load tensor in-graph (a captured
            # constant would bloat the program by q*m^dim*4 bytes)
            W = problem.stage_load(tf)
            W = W - apply_stiffness(fine, u, dim, mode)[None]
            return shard(mixer(A_inv, W))

        # Aop/Mop take tau/prec as EXPLICIT jit arguments (not closures):
        # gmres instantiates them at four structural sites (adaptive
        # cycle, full cycle, restart recompute, initial residual) and
        # explicit args let every site hit the same jit cache entry, so
        # the lowering emits ONE shared XLA computation instead of four
        # copies of the whole V-cycle machinery, and large arrays ride as
        # arguments instead of program constants.
        def raw_Aop(W, tau):
            W = shard(W)
            MW, KW = apply_mass_stiffness_batched(fine, W, dim, mode)
            return shard(mixer(A_inv, MW) + tau * KW)

        aop_jit = jax.jit(raw_Aop)

        # shared-computation mode only on huge grids, where four inlined
        # copies would multiply program size and compile time; elsewhere
        # the call boundaries would block fusion at the Mop edges.
        # SPIRK_SHARE_OPS=0/1 overrides the size heuristic (perf A/B).
        _so_env = os.environ.get("SPIRK_SHARE_OPS", "")
        share_ops = compact if _so_env == "" else _so_env == "1"

        def solve_fn(W_rhs, prec, tau):
            if share_ops:
                Aop = lambda W: aop_jit(W, tau)
            else:
                Aop = lambda W: raw_Aop(W, tau)

            def raw_Mop(v, carry, tau, prec):
                z = shard(mixer(T_inv, shard(v)))
                if sequential_stages:
                    # per-stage sequential solves, one GMG pipeline per
                    # stage (reference `irk`, main.cc:1122-1154)
                    outs = []
                    for i in range(q):
                        prec_i = jax.tree_util.tree_map(
                            lambda x: x[i], prec
                        )
                        if inner_tol > 0.0:
                            res = pcg(
                                lambda w: apply_shifted(
                                    fine, d_vec[i], tau, w, dim, mode
                                ),
                                z[i],
                                M=lambda r: vcycle(
                                    gmg, prec_i, d_vec[i], tau, r, dim, mode
                                ),
                                maxiter=100,
                                abstol=1e-10,
                                reltol=inner_tol,
                            )
                            outs.append(res.x)
                            carry = carry.at[i].add(res.n_iterations)
                        else:
                            outs.append(
                                vcycle(
                                    gmg, prec_i, d_vec[i], tau, z[i],
                                    dim, mode,
                                )
                            )
                            carry = carry.at[i].add(1)
                    z = jnp.stack(outs)
                elif inner_tol > 0.0 and not batched:
                    A_in = lambda Wb: shifted_b(d_vec, shard(Wb), tau)
                    M_in = lambda r: shard(
                        vcycle(
                            gmg, prec, d_vec, tau, shard(r), dim, mode,
                            batch=True,
                        )
                    )
                    res = pcg(
                        A_in,
                        z,
                        M=M_in,
                        maxiter=100,
                        abstol=1e-10,
                        reltol=inner_tol,
                        batch=True,
                    )
                    z = res.x
                    carry = carry + res.n_iterations
                else:
                    z = vcycle(
                        gmg, prec, d_vec, tau, z, dim, mode, batch=True
                    )
                    carry = carry + 1
                return shard(mixer(T, shard(z))), carry

            mop = jax.jit(raw_Mop) if share_ops else raw_Mop
            Mop = lambda v, carry: mop(v, carry, tau, prec)

            res = gmres(
                Aop,
                W_rhs,
                M=Mop,
                M_carry=jnp.zeros((q,), jnp.int32),
                maxiter=1000,
                abstol=1e-20,
                reltol=outer_tol,
                # deal.II-style 28-vector basis; at huge grids a compact
                # fixed basis instead (rationale at krylov.COMPACT_BASIS)
                restart=COMPACT_BASIS if compact else 28,
                adaptive=0 if compact else None,
            )
            return res.x, res.n_iterations, res.M_carry

        def update_fn(u, W, tau):
            return u + tau * jnp.einsum("i,i...->...", b_vec, W)

        # pieces exposed for replay-based phase profiling: the reference
        # times t_vmult / t_prec_bc / t_prec_solver inside its solver
        # loops (main.cc:998-1173); here the loops live in one compiled
        # program, so the run driver re-times the pieces afterwards and
        # scales by the recorded application counts.
        def vmult_piece(W, tau):
            MW, KW = apply_mass_stiffness_batched(fine, W, dim, mode)
            return mixer(A_inv, MW) + tau * KW

        def prec_bc_piece(W):
            return mixer(T, mixer(T_inv, W))

        def prec_solver_piece(W, prec, tau):
            return vcycle(gmg, prec, d_vec, tau, W, dim, mode, batch=True)

        self.vmult_piece = vmult_piece
        self.prec_bc_piece = prec_bc_piece
        self.prec_solver_piece = prec_solver_piece

        # raw functions (for composition into larger jitted programs)
        self.reinit_fn = reinit
        self.rhs_fn = rhs_fn
        self.solve_fn = solve_fn
        self.update_fn = update_fn
        self._reinit_jit = jax.jit(reinit)
        self._rhs_jit = jax.jit(rhs_fn)
        self._solve_jit = jax.jit(solve_fn)
        self._update_jit = jax.jit(update_fn)

    def _shard_stage(self, W):
        """Pin the stage axis of a (q, *spatial) array to the device mesh
        (spirk); identity when running single-device or purely batched."""
        if self.mesh is None:
            return W
        from ..parallel.sharding import stage_block_sharding

        return jax.lax.with_sharding_constraint(
            W, stage_block_sharding(self.mesh, W.ndim)
        )

    def _reinit(self, tau):
        return self._reinit_jit(jnp.asarray(tau, dtype=self.dtype))

    def solve_step(self, u, timestep_number, t, tau):
        prec = self.prec_state(tau)
        t_ = jnp.asarray(t, dtype=self.dtype)
        tau_ = jnp.asarray(tau, dtype=self.dtype)
        with self.timers.phase("total"):
            with self.timers.phase("rhs"):
                W_rhs = self._rhs_jit(u, t_, tau_)
                W_rhs.block_until_ready()
            with self.timers.phase("outer_solver"):
                W, n_outer, n_inner = self._solve_jit(W_rhs, prec, tau_)
                W.block_until_ready()
            with self.timers.phase("solution_update"):
                u = self._update_jit(u, W, tau_)
                u.block_until_ready()
        if int(n_outer) >= 1000:
            # reference aborts on solver non-convergence (main.cc:927-930)
            raise RuntimeError("outer GMRES did not converge within 1000 iterations")
        if self._compact_restart and int(n_outer) > self._compact_restart:
            import warnings

            warnings.warn(
                f"outer GMRES took {int(n_outer)} iterations — beyond the "
                f"{self._compact_restart}-column compact basis used at this "
                "grid size, so a restart fired where deal.II's 30-vector "
                "basis would not; iteration counts may diverge from the "
                "reference here",
                RuntimeWarning,
                stacklevel=2,
            )
        self.n_outer += int(n_outer)
        # keep the per-stage inner counts for per-stage time attribution
        # (reference t_prec_solver_0..9, main.cc:810-813)
        self.n_inner_stage = self.n_inner_stage + np.asarray(n_inner)
        if self.params.is_batched:
            # one block V-cycle counts once (reference main.cc:1115-1119)
            self.n_inner += int(np.asarray(n_inner)[0])
        else:
            self.n_inner += int(np.asarray(n_inner).sum())
        self.after_step(timestep_number, int(n_outer))
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        super().get_statistics(table, scaling_factor)
        self.add_per_stage_times(table, scaling_factor, self.q)
