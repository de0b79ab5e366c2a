"""Preconditioned CG and GMRES in pure JAX.

Semantics follow deal.II's solvers as used by the reference so iteration
counts are comparable:

* ``pcg``: standard preconditioned CG monitoring the *unpreconditioned*
  residual norm (deal.II SolverCG), ReductionControl-style stopping
  ``||r|| <= max(abstol, reltol * ||r0||)`` (reference ``main.cc:900``,
  ``main.cc:1126-1148``).
* ``gmres``: *left*-preconditioned GMRES with modified Gram–Schmidt and
  Givens rotations, restart length 28 (deal.II SolverGMRES default of 30
  temp vectors), monitoring the preconditioned residual.

Both support a ``batch`` mode: the leading axis of ``b`` indexes
independent systems (stages / eigenpairs) that share one loop but carry
per-lane tolerances, masks and iteration counters — converged lanes freeze
while the rest continue, yielding exactly the per-lane iteration counts of
sequential solves.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _dot(a, b, batch: bool):
    if batch:
        return jnp.sum(a * b, axis=tuple(range(1, a.ndim)))
    return jnp.sum(a * b)


def _expand(s, ref, batch: bool):
    if batch:
        return s.reshape(s.shape + (1,) * (ref.ndim - 1))
    return s


class KrylovResult(NamedTuple):
    x: jnp.ndarray
    n_iterations: jnp.ndarray  # scalar or (lanes,)
    residual: jnp.ndarray  # final monitored residual norm
    M_carry: object = None  # final preconditioner carry (stateful M only)


def pcg(
    A: Callable,
    b,
    *,
    M: Callable | None = None,
    x0=None,
    maxiter: int = 1000,
    abstol: float = 1e-20,
    reltol: float = 0.0,
    batch: bool = False,
) -> KrylovResult:
    """Preconditioned conjugate gradients (deal.II SolverCG semantics)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r0 = b
    else:
        r0 = b - A(x0)

    z0 = M(r0)
    rz0 = _dot(r0, z0, batch)
    rnorm0 = jnp.sqrt(_dot(r0, r0, batch))
    # floor the target at the dtype's achievable reduction (prevents
    # maxiter spins when e.g. a reference 1e-8/1e-12 tolerance is run in
    # f32); 32 eps relative is comfortably at the Krylov noise floor
    eps_floor = 32.0 * jnp.finfo(b.dtype).eps
    tol = jnp.maximum(abstol, jnp.maximum(reltol, eps_floor) * rnorm0)

    def cond(state):
        _x, _r, _p, _rz, rnorm, k, _ = state
        active = (rnorm > tol) & (k < maxiter)
        return jnp.any(active)

    def body(state):
        x, r, p, rz, rnorm, k, iters = state
        active = rnorm > tol
        Ap = A(p)
        pAp = _dot(p, Ap, batch)
        alpha = jnp.where(pAp != 0, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
        am = _expand(jnp.where(active, alpha, 0.0), x, batch)
        x = x + am * p
        r = r - am * Ap
        z = M(r)
        rz_new = _dot(r, z, batch)
        beta = jnp.where(rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
        bm = _expand(jnp.where(active, beta, 0.0), x, batch)
        keep = _expand(active.astype(x.dtype), x, batch)
        p = jnp.where(keep > 0, z + bm * p, p)
        rz = jnp.where(active, rz_new, rz)
        rnorm = jnp.where(active, jnp.sqrt(_dot(r, r, batch)), rnorm)
        iters = iters + active.astype(jnp.int32)
        return x, r, p, rz, rnorm, k + 1, iters

    zero_iters = (
        jnp.zeros(b.shape[0], dtype=jnp.int32) if batch else jnp.int32(0)
    )
    state = (x0, r0, z0, rz0, rnorm0, jnp.int32(0), zero_iters)
    x, _r, _p, _rz, rnorm, _k, iters = lax.while_loop(cond, body, state)
    return KrylovResult(x=x, n_iterations=iters, residual=rnorm)


def cg_lanczos_extremal_eigs(
    A: Callable,
    b,
    *,
    M: Callable | None = None,
    n_iterations: int = 20,
    batch: bool = False,
):
    """Estimate extremal eigenvalues of M^-1 A via CG-Lanczos.

    Runs a fixed number of preconditioned CG iterations collecting the
    Lanczos tridiagonal from the alpha/beta coefficients, then solves the
    small symmetric eigenproblem.  This mirrors deal.II's
    ``PreconditionChebyshev`` eigenvalue estimation with
    ``eig_cg_n_iterations`` (reference ``preconditioner.h:219-232``,
    ``preconditioner.h:354-373``).

    Returns ``(lambda_min, lambda_max)`` (per lane when ``batch``).
    """
    if M is None:
        M = lambda r: r
    n = n_iterations
    lane_shape = (b.shape[0],) if batch else ()

    def body(k, state):
        x, r, p, rz, alphas, betas = state
        Ap = A(p)
        pAp = _dot(p, Ap, batch)
        safe = jnp.abs(pAp) > 1e-300
        alpha = jnp.where(safe, rz / jnp.where(safe, pAp, 1.0), 1.0)
        x = x + _expand(alpha, x, batch) * p
        r = r - _expand(alpha, r, batch) * Ap
        z = M(r)
        rz_new = _dot(r, z, batch)
        safe2 = jnp.abs(rz) > 1e-300
        beta = jnp.where(safe2, rz_new / jnp.where(safe2, rz, 1.0), 0.0)
        p = z + _expand(beta, p, batch) * p
        alphas = alphas.at[..., k].set(alpha)
        betas = betas.at[..., k].set(beta)
        return x, r, p, rz_new, alphas, betas

    x0 = jnp.zeros_like(b)
    z0 = M(b)
    rz0 = _dot(b, z0, batch)
    alphas = jnp.zeros(lane_shape + (n,), dtype=b.dtype)
    betas = jnp.zeros(lane_shape + (n,), dtype=b.dtype)
    state = (x0, b, z0, rz0, alphas, betas)
    _, _, _, _, alphas, betas = lax.fori_loop(0, n, body, state)

    # tridiagonal: diag_k = 1/alpha_k + beta_{k-1}/alpha_{k-1},
    #              offdiag_k = sqrt(beta_k)/alpha_k
    inv_a = 1.0 / alphas
    diag = inv_a + jnp.concatenate(
        [
            jnp.zeros(lane_shape + (1,), b.dtype),
            betas[..., :-1] * inv_a[..., :-1],
        ],
        axis=-1,
    )
    off = jnp.sqrt(jnp.maximum(betas[..., :-1], 0.0)) * inv_a[..., :-1]

    def tridiag_eigs(d, e):
        T = jnp.diag(d) + jnp.diag(e, 1) + jnp.diag(e, -1)
        w = jnp.linalg.eigvalsh(T)
        return w[0], w[-1]

    if batch:
        return jax.vmap(tridiag_eigs)(diag, off)
    return tridiag_eigs(diag, off)


# Huge-grid GMRES policy, shared by schemes/irk.py and
# schemes/complex_irk.py (single source for the threshold + width —
# the escalation warning, the restart choice and the shared-ops mode
# must all flip together): above COMPACT_GRID_DOFS per-stage dofs the
# deal.II-style 28-vector basis is replaced by a fixed COMPACT_BASIS
# columns (28 x 265 MB of basis = 7.7 GB of device memory at refinement
# 8, and the adaptive pre-cycle doubles the program; solves take 4-6
# outer iterations, so 12 columns lose nothing — a restart past them is
# warned about as a parity divergence).
COMPACT_GRID_DOFS = 8_000_000
COMPACT_BASIS = 12


def gmres(
    A: Callable,
    b,
    *,
    M: Callable | None = None,
    M_carry=None,
    x0=None,
    maxiter: int = 1000,
    abstol: float = 1e-20,
    reltol: float = 0.0,
    restart: int = 28,
    batch: bool = False,
    orthog: str | None = None,
    adaptive: int | None = None,
) -> KrylovResult:
    """Left-preconditioned GMRES(restart) with Givens rotations.

    ``adaptive`` (default from ``SPIRK_GMRES_ADAPTIVE``, else 12): the
    deal.II-style "allocate tmp vectors as needed" analog for a static
    graph.  A first cycle runs with a small ``adaptive``-column basis; if
    every lane converges inside it — the production case: these solves
    take 4-10 iterations while deal.II's default basis is 30 vectors
    (reference outer solver ``main.cc:920-925``) — the result is
    IDENTICAL to the full-restart run (same Krylov space, no restart
    triggered) at a third of the basis memory/zeroing traffic.  If a
    lane is still unconverged, the small cycle's Krylov state (basis,
    rotated Hessenberg, Givens rotations) is embedded into the full
    ``restart``-column buffers and the SAME cycle CONTINUES from
    iteration ``adaptive`` — mathematically identical iterates to one
    long deal.II cycle (same basis, same rotations), so iteration
    counts keep exact deal.II parity in every case and no work is
    discarded at the escalation boundary.  ``0`` disables.

    ``orthog`` selects the orthogonalization scheme (default from
    ``SPIRK_GMRES_ORTHOG``, else ``"mgs"``):

    * ``"mgs"`` (default): modified Gram-Schmidt — a dynamic-bound loop
      over the k+1 live basis columns.  It touches only the live
      columns, while CGS pays two passes over the whole
      ``restart+1``-column basis buffer every iteration.
    * ``"cgs"``: classical Gram-Schmidt as two multiply+reduce passes
      over the basis buffer — deal.II's own default orthogonalization,
      kept for semantic parity and for small/many-iteration systems
      where a fixed per-iteration cost beats a growing one.  Identical
      iteration counts to MGS in every covered configuration (both
      monitored in the test suite).

    When ``M_carry`` is given, ``M`` must have the stateful signature
    ``M(v, carry) -> (z, carry)``; the carry is threaded through every
    preconditioner application and returned (used by the IRK schemes to
    accumulate inner-solve iteration counts, mirroring the reference's
    ``get_n_iterations_and_clear`` at ``main.cc:1176-1182``).
    """
    if orthog is None:
        import os

        orthog = os.environ.get("SPIRK_GMRES_ORTHOG", "mgs")
    # A and M contain the operator/preconditioner machinery (V-cycles,
    # fused kernels) and appear at FOUR structural call sites (adaptive
    # small-basis cycle, full cycle, restart-recompute branch, initial
    # residual).  Nested jit makes every site call ONE shared lowered
    # computation instead of embedding four copies, which keeps the
    # refinement-8 program (and its compile time) to one copy of the
    # machinery.  XLA inlines called computations during optimization,
    # so the executed program is unchanged.
    if M is None:
        Ms = lambda v, c: (v, c)
        carry0 = jnp.int32(0)
    elif M_carry is None:
        Ms = lambda v, c: (M(v), c)
        carry0 = jnp.int32(0)
    else:
        Ms = M
        carry0 = M_carry

    if x0 is None:
        x0 = jnp.zeros_like(b)
        r0, carry0 = Ms(b, carry0)
    else:
        r0, carry0 = Ms(b - A(x0), carry0)

    dtype = b.dtype
    lanes = b.shape[0] if batch else None
    lane_shape = (lanes,) if batch else ()
    R = restart

    beta0 = jnp.sqrt(_dot(r0, r0, batch))
    # dtype-aware floor: see pcg
    eps_floor = 32.0 * jnp.finfo(b.dtype).eps
    tol = jnp.maximum(abstol, jnp.maximum(reltol, eps_floor) * beta0)

    stateful = M is not None and M_carry is not None

    def _mask_carry(new, old, active):
        if not stateful:
            return old

        def f(n, o):
            if batch and getattr(n, "ndim", 0) >= 1:
                act = active.reshape(active.shape + (1,) * (n.ndim - 1))
                return jnp.where(act, n, o)
            return jnp.where(active, n, o)

        return jax.tree_util.tree_map(f, new, old)

    def make_cycle(Rc: int):
        return partial(_cycle, Rc)

    def _cycle(Rc, x, r, res, total_iters, carry, init=None,
               ret_state=False):
        """One restart cycle from x with preconditioned residual r,
        basis size ``Rc``.

        ``init``: optional Krylov state ``(V, H, g, cs, sn, k)`` from a
        smaller-basis cycle of the SAME system — embedded into this
        cycle's buffers so the iteration continues from column ``k``
        (the adaptive-escalation path; see the ``adaptive`` docstring).
        ``ret_state`` additionally returns this cycle's final state.
        """
        if init is None:
            beta = jnp.sqrt(_dot(r, r, batch))
            safe_beta = jnp.where(beta > 0, beta, 1.0)
            v0 = r / _expand(safe_beta, r, batch)

            V = jnp.zeros((Rc + 1,) + b.shape, dtype)
            V = V.at[0].set(v0)
            H = jnp.zeros(lane_shape + (Rc + 1, Rc), dtype)  # rotated
            g = jnp.zeros(lane_shape + (Rc + 1,), dtype)
            g = g.at[..., 0].set(beta)
            cs = jnp.zeros(lane_shape + (Rc,), dtype)
            sn = jnp.zeros(lane_shape + (Rc,), dtype)
            k0 = jnp.int32(0)
        else:
            V_s, H_s, g_s, cs_s, sn_s, k0 = init
            a = V_s.shape[0] - 1  # small-basis column count
            # NOTE: both bases are live during this copy, a transient of
            # (a+1) extra basis vectors over the full cycle's (Rc+1) —
            # bounded and non-binding here because at huge grids
            # (> COMPACT_GRID_DOFS) the adaptive pre-cycle is disabled
            # entirely and this path never runs (schemes/irk.py).
            V = jnp.zeros((Rc + 1,) + b.shape, dtype).at[: a + 1].set(V_s)
            H = (
                jnp.zeros(lane_shape + (Rc + 1, Rc), dtype)
                .at[..., : a + 1, :a]
                .set(H_s)
            )
            g = jnp.zeros(lane_shape + (Rc + 1,), dtype).at[..., : a + 1].set(
                g_s
            )
            cs = jnp.zeros(lane_shape + (Rc,), dtype).at[..., :a].set(cs_s)
            sn = jnp.zeros(lane_shape + (Rc,), dtype).at[..., :a].set(sn_s)

        def cond(st):
            _V, _H, _g, _cs, _sn, k, res, it, _carry = st
            return jnp.any((res > tol) & (k < Rc) & (it < maxiter))

        def body(st):
            V, H, g, cs, sn, k, res, it, carry = st
            active = (res > tol) & (it < maxiter)
            w, carry_new = Ms(A(V[k]), carry)
            carry = _mask_carry(carry_new, carry, active)
            if orthog == "cgs":
                # classical Gram-Schmidt: one reduction pass + one
                # update pass over the whole basis buffer, as plain
                # multiply+reduce fusions (a dot_general with a
                # mid-position batch dim can transpose the basis
                # buffer).  Rows > k are still zero, so the unused columns
                # contribute nothing; the mask keeps that explicit.
                cmask = (jnp.arange(Rc + 1) <= k).astype(dtype)
                red_axes = tuple(range(2 if batch else 1, V.ndim))
                dots = jnp.sum(V * w[None], axis=red_axes)
                dots = dots * (cmask[:, None] if batch else cmask)
                dexp = dots.reshape(dots.shape + (1,) * (V.ndim - dots.ndim))
                w = w - jnp.sum(dexp * V, axis=0)
                hcol = dots.T if batch else dots
            else:
                # modified Gram-Schmidt against all previous vectors
                hcol = jnp.zeros(lane_shape + (Rc + 1,), dtype)

                def mgs(j, carry):
                    w, hcol = carry
                    hij = _dot(V[j], w, batch)
                    w = w - _expand(hij, w, batch) * V[j]
                    hcol = hcol.at[..., j].set(hij)
                    return w, hcol

                # dynamic trip count: only the k+1 live basis vectors
                w, hcol = lax.fori_loop(0, k + 1, mgs, (w, hcol))
            hk1 = jnp.sqrt(_dot(w, w, batch))
            hcol = hcol.at[..., k + 1].set(hk1)
            safe_h = jnp.where(hk1 > 0, hk1, 1.0)
            V = V.at[k + 1].set(w / _expand(safe_h, w, batch))

            # apply existing Givens rotations to the new column
            def rot(j, hcol):
                hj = hcol[..., j]
                hj1 = hcol[..., j + 1]
                c = cs[..., j]
                s = sn[..., j]
                hcol = hcol.at[..., j].set(c * hj + s * hj1)
                return hcol.at[..., j + 1].set(-s * hj + c * hj1)

            hcol = lax.fori_loop(0, k, rot, hcol)

            # new rotation annihilating hcol[k+1]
            hk = hcol[..., k] if batch else hcol[k]
            hk1r = hcol[..., k + 1] if batch else hcol[k + 1]
            denom = jnp.sqrt(hk**2 + hk1r**2)
            safe_d = jnp.where(denom > 0, denom, 1.0)
            c_new = jnp.where(denom > 0, hk / safe_d, 1.0)
            s_new = jnp.where(denom > 0, hk1r / safe_d, 0.0)
            hcol = hcol.at[..., k].set(denom)
            hcol = hcol.at[..., k + 1].set(jnp.zeros_like(denom))

            gk = g[..., k]
            g_new_k = c_new * gk
            g_new_k1 = -s_new * gk

            # masked writes: frozen lanes keep their state
            def upd_vec(new, old):
                return jnp.where(active, new, old)

            H = H.at[..., :, k].set(
                jnp.where(
                    active[..., None] if batch else active,
                    hcol,
                    H[..., :, k],
                )
            )
            cs = cs.at[..., k].set(upd_vec(c_new, cs[..., k]))
            sn = sn.at[..., k].set(upd_vec(s_new, sn[..., k]))
            g = g.at[..., k].set(upd_vec(g_new_k, g[..., k]))
            g = g.at[..., k + 1].set(upd_vec(g_new_k1, g[..., k + 1]))
            res = jnp.where(active, jnp.abs(g_new_k1), res)
            it = it + active.astype(jnp.int32)
            return V, H, g, cs, sn, k + 1, res, it, carry

        st = (V, H, g, cs, sn, k0, res, total_iters, carry)
        V, H, g, cs, sn, k, res, it, carry = lax.while_loop(cond, body, st)

        # back-substitution on the rotated (upper-triangular) H
        Rm = H[..., :Rc, :Rc]
        idx = jnp.arange(Rc)

        def solve_lane(Rl, gl, kl):
            pad = jnp.where(idx >= kl, 1.0, 0.0)
            Afull = Rl + jnp.diag(pad)
            gl = jnp.where(idx < kl, gl[:Rc], 0.0)
            y = jax.scipy.linalg.solve_triangular(Afull, gl, lower=False)
            return y

        # accumulate dx = sum_j y_j V_j with a dynamic loop over the live
        # Krylov columns only — a dense contraction would read the whole
        # (R+1)-vector basis buffer regardless of how few columns are used
        if batch:
            # per-lane Krylov size this cycle: count of columns written
            k_sz = jnp.sum(jnp.abs(H[..., idx, idx]) > 0, axis=-1)
            y = jax.vmap(solve_lane)(Rm, g, k_sz)  # zero beyond each lane's k
            k_max = jnp.max(k_sz)

            def acc_fn(j, dx):
                return dx + _expand(y[:, j], x, batch) * V[j]

            dx = lax.fori_loop(0, k_max, acc_fn, jnp.zeros_like(x))
        else:
            k_sz = jnp.sum(jnp.abs(Rm[idx, idx]) > 0)
            y = solve_lane(Rm, g, k_sz)

            def acc_fn(j, dx):
                return dx + y[j] * V[j]

            dx = lax.fori_loop(0, k_sz, acc_fn, jnp.zeros_like(x))
        if ret_state:
            return x + dx, res, it, carry, (V, H, g, cs, sn, k)
        return x + dx, res, it, carry

    cycle = make_cycle(R)

    def outer_cond(st):
        _x, _r, res, it, _carry = st
        return jnp.any((res > tol) & (it < maxiter))

    def _refresh_if(gate, x, r, res, carry, mask):
        """Recompute the (preconditioned) residual only when a restart
        will actually continue (``jnp.any(gate)``) — deal.II exits on the
        Givens estimate without a final recompute, and the recompute
        costs a full vmult + preconditioner application.  ``mask`` limits
        which lanes may update their res/carry."""

        def recompute(args):
            x_, r_, res_, carry_ = args
            r_new, carry_new = Ms(b - A(x_), carry_)
            carry2 = _mask_carry(carry_new, carry_, mask)
            res_new = jnp.sqrt(_dot(r_new, r_new, batch))
            return r_new, jnp.where(mask, res_new, res_), carry2

        def skip(args):
            _x, r_, res_, carry_ = args
            return r_, res_, carry_

        return lax.cond(jnp.any(gate), recompute, skip, (x, r, res, carry))

    def outer_body(st):
        x, r, res, it, carry = st
        active = (res > tol) & (it < maxiter)
        x, res, it, carry = cycle(x, r, res, it, carry)
        # only lanes that were active this cycle may update their carry
        still = (res > tol) & (it < maxiter)
        r, res, carry = _refresh_if(still, x, r, res, carry, active)
        return x, r, res, it, carry

    zero_it = jnp.zeros(lane_shape, jnp.int32) if batch else jnp.int32(0)

    def run_full(_):
        x, _r, res, iters, carry = lax.while_loop(
            outer_cond, outer_body, (x0, r0, beta0, zero_it, carry0)
        )
        return x, res, iters, carry

    if adaptive is None:
        import os

        adaptive = int(os.environ.get("SPIRK_GMRES_ADAPTIVE", "12"))
    if adaptive and adaptive < R and maxiter > adaptive:
        # small-basis first cycle; if any lane is still unconverged,
        # CONTINUE the same cycle with the full basis from the embedded
        # small-basis state (no discarded work) — see the docstring
        x_s, res_s, it_s, carry_s, small_state = _cycle(
            adaptive, x0, r0, beta0, zero_it, carry0, ret_state=True
        )

        def run_cont(_):
            # resume from the small cycle's residual estimates, iteration
            # counts and preconditioner carry; x0/r0 are only the cycle's
            # expansion point (dx spans the whole embedded basis)
            x, res, it, carry = _cycle(
                R, x0, r0, res_s, it_s, carry_s, init=small_state
            )
            still = (res > tol) & (it < maxiter)
            r, res, carry = _refresh_if(still, x, r0, res, carry, still)
            x, _r, res, it, carry = lax.while_loop(
                outer_cond, outer_body, (x, r, res, it, carry)
            )
            return x, res, it, carry

        x, res, iters, carry = lax.cond(
            jnp.all(res_s <= tol),
            lambda _: (x_s, res_s, it_s, carry_s),
            run_cont,
            None,
        )
    else:
        x, res, iters, carry = run_full(None)
    return KrylovResult(
        x=x, n_iterations=iters, residual=res, M_carry=carry
    )
