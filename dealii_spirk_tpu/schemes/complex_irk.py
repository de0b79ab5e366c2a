"""Complex-diagonalized IRK — ``complex_irk(_batched)`` /
``complex_spirk(_batched)``.

Mathematics (reference ``main.cc:1886-2375`` and ``main.cc:2382-2934``):
the stage system is diagonalized *exactly* with the complex
eigendecomposition ``A^{-1} = V diag(lambda) V^{-1}``, so there is no
outer Krylov iteration — one application of the complex preconditioner IS
the solve (reference ``main.cc:2029``):

1. apply complex ``T^{-1}`` to the q real stage right-hand sides, keeping
   one representative per conjugate pair: ceil(q/2) (re, im) pair blocks
   (reference ``main.cc:2149-2155``);
2. for each pair, solve ``((lambda_re + i lambda_im) M + tau K) w = z`` in
   2x2 real-block form by GMRES to OuterTolerance, preconditioned by PRESB
   (two shifted-GMG solves per application, reference ``main.cc:2284-2335``)
   or by a block GMG V-cycle in the ``_batched`` variant;
3. map back with the conjugate-pair doubling ``2 Re(T w)`` (reference
   ``main.cc:2216-2225``).

Realization: the pair axis is a masked-batched GMRES lane axis (each
pair keeps its own iteration count — matching the reference's sequential
per-pair solves) or a device-mesh axis (``complex_spirk``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import irk_tables
from ..ops.mass_laplace import (
    apply_mass_batched,
    apply_shifted_batched,
    apply_stiffness,
)
from ..solvers.gmg import gmg_reinit, vcycle
from ..solvers.krylov import COMPACT_BASIS, COMPACT_GRID_DOFS, gmres, pcg
from .base import SchemeBase, stage_mix, stage_times_factor


class ComplexIRK(SchemeBase):
    def __init__(self, problem, params, mesh=None):
        super().__init__(problem, params)
        self.mesh = mesh
        q = params.irk_stages
        self.q = q
        tabs = irk_tables(q)
        n2 = tabs.n_pairs
        self.n_pairs = n2
        dt = self.dtype

        A_inv = jnp.asarray(tabs.A_inv, dtype=dt)
        b_vec = jnp.asarray(tabs.b, dtype=dt)
        c_vec = jnp.asarray(tabs.c, dtype=dt)
        # pair representatives: rows/columns at even indices
        T_inv_re2 = jnp.asarray(tabs.T_inv_re[::2], dtype=dt)  # (n2, q)
        T_inv_im2 = jnp.asarray(tabs.T_inv_im[::2], dtype=dt)
        d_re2 = jnp.asarray(tabs.D_re[::2], dtype=dt)  # (n2,)
        d_im2 = jnp.asarray(tabs.D_im[::2], dtype=dt)
        # back map with conjugate doubling (reference main.cc:2216-2225)
        scal = np.where(np.arange(n2) < q // 2, 2.0, 1.0)
        T_re_s = jnp.asarray(tabs.T_re[:, ::2] * scal, dtype=dt)  # (q, n2)
        T_im_s = jnp.asarray(tabs.T_im[:, ::2] * scal, dtype=dt)

        gmg, fine = self.gmg, self.fine
        dim, mode = self.dim, self.mode
        inner_tol = params.inner_tolerance
        outer_tol = params.outer_tolerance
        batched = params.is_batched
        shard = self._shard_pair

        shifts = d_re2 + d_im2  # PRESB / block-GMG shifts (main.cc:1959)

        spatial = (fine.m,) * dim
        # compact fixed basis at huge grids: see schemes/irk.py
        # ONE evaluation of the huge-grid predicate: the escalation
        # warning, the restart/adaptive choice and the shared-ops mode
        # must flip together (krylov.COMPACT_GRID_DOFS)
        compact = int(np.prod(spatial)) > COMPACT_GRID_DOFS
        self._compact_restart = COMPACT_BASIS if compact else 0

        mass_b = lambda W: apply_mass_batched(fine, W, dim, mode)
        shifted_b = lambda si, Wi, tau: apply_shifted_batched(
            fine, si, tau, Wi, dim, mode
        )

        def complex_b(d_re, d_im, Z, tau):
            """2x2 block complex apply over pair blocks (n2, 2, *spatial)
            (reference operator.h:593-666), flattened so the fused batched
            operator serves both components in one sweep."""
            flat = Z.reshape((Z.shape[0] * 2,) + Z.shape[2:])
            S = shifted_b(jnp.repeat(d_re, 2), flat, tau).reshape(Z.shape)
            Mz = mass_b(flat).reshape(Z.shape)
            lam = d_im.reshape((Z.shape[0],) + (1,) * dim)
            cross = jnp.stack([-lam * Mz[:, 1], lam * Mz[:, 0]], axis=1)
            return S + cross

        def reinit(tau):
            if batched:
                # block GMG: both (re, im) components share the pair's shift
                shifts_rep = jnp.repeat(shifts, 2)
                return gmg_reinit(gmg, shifts_rep, tau, dim, mode, batch=True)
            return gmg_reinit(gmg, shifts, tau, dim, mode, batch=True)

        def rhs_fn(u, t, tau):
            tf = stage_times_factor(c_vec, t, tau, dim).astype(dt)
            W = problem.stage_load(tf)
            W = W - apply_stiffness(fine, u, dim, mode)[None]
            return stage_mix(A_inv, W)

        def _vc(prec, s_vec, tau, r):
            return vcycle(gmg, prec, s_vec, tau, r, dim, mode, batch=True)

        def inner_solve(rhs_pairs, prec, tau):
            """Solve (shift_i M + tau K) x = rhs for all pairs at once."""
            if inner_tol == 0.0:
                x = _vc(prec, shifts, tau, rhs_pairs)
                return x, jnp.ones((rhs_pairs.shape[0],), jnp.int32)
            res = pcg(
                lambda Wb: shifted_b(shifts, Wb, tau),
                rhs_pairs,
                M=lambda r: _vc(prec, shifts, tau, r),
                maxiter=100,
                # the reference PRESB uses an *absolute* SolverControl
                # tolerance here (main.cc:2302)
                abstol=inner_tol,
                batch=True,
            )
            return res.x, res.n_iterations

        # explicit-args jitted Aop/Mop: one shared lowered computation
        # across gmres's structural call sites (see schemes/irk.py)
        def raw_Aop(Zv, tau):
            return shard(complex_b(d_re2, d_im2, shard(Zv), tau))

        aop_jit = jax.jit(raw_Aop)

        if batched:

            def raw_Mop(v, carry, tau, prec):
                vv = v.reshape((n2 * 2,) + v.shape[2:])
                out = _vc(prec, jnp.repeat(shifts, 2), tau, vv)
                return shard(out.reshape(v.shape)), carry + 1

        else:

            def raw_Mop(v, carry, tau, prec):
                """PRESB (reference main.cc:2284-2335):
                x0 ~ (S)^{-1}(v_re + v_im);  S = (l_re + l_im) M + tau K
                x1 ~ (S)^{-1}(v_im - l_im M x0);  out = (x0 - x1, x1)."""
                v = shard(v)
                t0 = v[:, 0] + v[:, 1]
                x0, c0 = inner_solve(t0, prec, tau)
                lam = d_im2.reshape((n2,) + (1,) * dim)
                t1 = v[:, 1] - lam * mass_b(x0)
                x1, c1 = inner_solve(t1, prec, tau)
                out = jnp.stack([x0 - x1, x1], axis=1)
                return shard(out), carry + jnp.stack([c0, c1], axis=1)

        share_ops = compact  # see schemes/irk.py
        mop_jit = jax.jit(raw_Mop) if share_ops else raw_Mop

        def solve_fn(W_rhs, prec, tau):
            # complex T^{-1}: q real blocks -> n2 (re, im) pairs
            Z = jnp.stack(
                [stage_mix(T_inv_re2, W_rhs), stage_mix(T_inv_im2, W_rhs)],
                axis=1,
            )  # (n2, 2, *spatial)
            Z = shard(Z)

            Aop = lambda Zv: (
                aop_jit(Zv, tau) if share_ops else raw_Aop(Zv, tau)
            )
            Mop = lambda v, carry: mop_jit(v, carry, tau, prec)
            carry0 = jnp.zeros((n2, 2), jnp.int32)

            res = gmres(
                Aop,
                Z,
                M=Mop,
                M_carry=carry0,
                maxiter=1000,
                abstol=1e-20,
                reltol=outer_tol,
                # compact fixed basis at huge grids (see schemes/irk.py)
                restart=COMPACT_BASIS if compact else 28,
                adaptive=0 if compact else None,
                batch=True,
            )
            zr, zi = res.x[:, 0], res.x[:, 1]
            W = stage_mix(T_re_s, zr) - stage_mix(T_im_s, zi)
            return W, res.n_iterations, res.M_carry

        def update_fn(u, W, tau):
            return u + tau * jnp.einsum("i,i...->...", b_vec, W)

        # replay pieces for phase profiling (cf. schemes/base.py)
        def vmult_piece(Z, tau):
            # Z: (n2, 2, *spatial) pair blocks
            return complex_b(d_re2, d_im2, Z, tau)

        def prec_bc_piece(W):
            Z = jnp.stack(
                [stage_mix(T_inv_re2, W), stage_mix(T_inv_im2, W)], axis=1
            )
            return jnp.einsum("ji,i...->j...", T_re_s, Z[:, 0]) - jnp.einsum(
                "ji,i...->j...", T_im_s, Z[:, 1]
            )

        def prec_solver_piece(W, prec, tau):
            # W here: (n2, *spatial) pair-shift solves
            return inner_solve(W, prec, tau)[0]

        self.vmult_piece = None  # pair-block shapes differ; see profile_phases
        self._cpx_vmult = vmult_piece
        self._cpx_bc = prec_bc_piece
        self._cpx_solver = prec_solver_piece

        # raw functions (for composition into larger jitted programs)
        self.reinit_fn = reinit
        self.rhs_fn = rhs_fn
        self.solve_fn = solve_fn
        self.update_fn = update_fn
        self._reinit_jit = jax.jit(reinit)
        self._rhs_jit = jax.jit(rhs_fn)
        self._solve_jit = jax.jit(solve_fn)
        self._update_jit = jax.jit(update_fn)

    def _shard_pair(self, Z):
        if self.mesh is None:
            return Z
        from ..parallel.sharding import stage_block_sharding

        # pair blocks are (n2, 2, *spatial); per-pair component arrays
        # inside PRESB are (n2, *spatial)
        spatial_start = 2 if Z.ndim == 2 + self.dim else 1
        return jax.lax.with_sharding_constraint(
            Z, stage_block_sharding(self.mesh, Z.ndim, spatial_start)
        )

    def _reinit(self, tau):
        return self._reinit_jit(jnp.asarray(tau, dtype=self.dtype))

    def profile_phases(self, tau, n_steps):
        """Replay-based phase timers for the complex family (pair-block
        shapes; see schemes/base.py for the convention)."""
        import time as _time

        import jax

        prec = self.prec_state(tau)
        n2 = self.n_pairs
        sp = self.problem.space.shape
        Z = jnp.ones((n2, 2) + sp, dtype=self.dtype)
        Wq = jnp.ones((self.q,) + sp, dtype=self.dtype)
        Wp = jnp.ones((n2,) + sp, dtype=self.dtype)
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

        t_vmult = timed(lambda z: self._cpx_vmult(z, tau_), Z)
        t_bc = timed(self._cpx_bc, Wq)
        t_ps = timed(lambda w: self._cpx_solver(w, prec, tau_), Wp)

        steps = max(n_steps, 1)
        # exact structural counts of the per-pair left-preconditioned
        # GMRES (see schemes/base.py): the batched pair vmult runs once
        # per (average) pair iteration, the preconditioner once per
        # iteration plus the initial M(b) residual
        n_pair = self.n_outer / steps / max(n2, 1)
        self.timers.seconds["system_vmult"] = t_vmult * n_pair * steps
        self.timers.seconds["preconditioner_bc"] = t_bc * steps
        # PRESB performs two shifted solves per application
        self.timers.seconds["preconditioner_solver"] = (
            t_ps * 2.0 * (n_pair + 1.0) * steps
        )

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
        if int(np.asarray(n_outer).max()) >= 1000:
            # reference aborts on solver non-convergence (main.cc:1386-1389)
            raise RuntimeError("pair GMRES did not converge within 1000 iterations")
        if (
            self._compact_restart
            and int(np.asarray(n_outer).max()) > self._compact_restart
        ):
            import warnings

            warnings.warn(
                f"a pair GMRES lane took {int(np.asarray(n_outer).max())} "
                f"iterations — beyond the {self._compact_restart}-column "
                "compact basis used at this grid size, so a restart fired "
                "where deal.II's 30-vector basis would not; iteration "
                "counts may diverge from the reference here",
                RuntimeWarning,
                stacklevel=2,
            )
        self.n_outer += int(np.asarray(n_outer).sum())
        self.n_inner += int(np.asarray(n_inner).sum())
        # per-pair outer counts drive the per-group time attribution
        # (reference t_prec_solver_0..9, main.cc:810-813): each conjugate
        # pair's GMRES is an independent lane
        n_pairs = np.asarray(n_outer).shape[0] if np.asarray(n_outer).ndim else 1
        self.n_inner_stage[:n_pairs] = self.n_inner_stage[:n_pairs] + np.asarray(
            n_outer
        ).reshape(-1)
        self.after_step(timestep_number, int(np.asarray(n_outer).sum()))
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        super().get_statistics(table, scaling_factor)
        self.add_per_stage_times(table, scaling_factor, self.n_pairs)
