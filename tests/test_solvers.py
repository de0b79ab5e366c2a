"""Tests for Krylov solvers, Chebyshev smoothing, and GMG."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dealii_spirk_tpu.fem.grid import make_space
from dealii_spirk_tpu.ops.mass_laplace import (
    apply_shifted,
    level_ops,
    operator_diagonal,
)
from dealii_spirk_tpu.solvers.chebyshev import (
    chebyshev_apply,
    estimate_chebyshev_range,
)
from dealii_spirk_tpu.solvers.gmg import build_gmg_data, gmg_reinit, vcycle
from dealii_spirk_tpu.solvers.krylov import gmres, pcg


def _random_spd(n, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n)


def test_pcg_solves_spd():
    n = 40
    A = jnp.asarray(_random_spd(n))
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(n))
    res = pcg(lambda x: A @ x, b, maxiter=200, reltol=1e-12)
    np.testing.assert_allclose(res.x, np.linalg.solve(A, b), atol=1e-8)
    assert int(res.n_iterations) > 0


def test_pcg_preconditioned_fewer_iterations():
    n = 60
    A = jnp.asarray(_random_spd(n, seed=2))
    b = jnp.ones(n)
    plain = pcg(lambda x: A @ x, b, maxiter=500, reltol=1e-10)
    Ainv = jnp.linalg.inv(A)
    prec = pcg(
        lambda x: A @ x, b, M=lambda r: Ainv @ r, maxiter=500, reltol=1e-10
    )
    assert int(prec.n_iterations) <= 2
    assert int(prec.n_iterations) < int(plain.n_iterations)


def test_pcg_batched_matches_sequential():
    n = 30
    A0 = jnp.asarray(_random_spd(n, seed=3))
    shifts = jnp.asarray([1.0, 5.0, 25.0])
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal((3, n)))

    def A(v):
        return jnp.einsum("ij,qj->qi", A0, v) + shifts[:, None] * v

    res = pcg(A, b, maxiter=300, reltol=1e-10, batch=True)
    iters = np.asarray(res.n_iterations)
    for i in range(3):
        Ai = np.asarray(A0) + float(shifts[i]) * np.eye(n)
        single = pcg(
            lambda x: jnp.asarray(Ai) @ x, b[i], maxiter=300, reltol=1e-10
        )
        np.testing.assert_allclose(res.x[i], single.x, atol=1e-7)
        assert iters[i] == int(single.n_iterations)


def test_gmres_nonsymmetric():
    n = 40
    rng = np.random.default_rng(5)
    A = jnp.asarray(np.eye(n) * 4 + 0.5 * rng.standard_normal((n, n)))
    b = jnp.asarray(rng.standard_normal(n))
    res = gmres(lambda x: A @ x, b, maxiter=200, reltol=1e-12)
    np.testing.assert_allclose(res.x, np.linalg.solve(A, b), atol=1e-8)


def test_gmres_restart():
    # force restarts with a small restart length
    n = 50
    rng = np.random.default_rng(6)
    A = jnp.asarray(np.diag(np.linspace(1, 50, n)) + 0.3 * rng.standard_normal((n, n)))
    b = jnp.asarray(rng.standard_normal(n))
    res = gmres(lambda x: A @ x, b, maxiter=500, reltol=1e-10, restart=8)
    np.testing.assert_allclose(res.x, np.linalg.solve(A, b), atol=1e-6)


def test_gmres_batched_matches_sequential():
    n = 30
    rng = np.random.default_rng(7)
    A0 = jnp.asarray(np.eye(n) * 5 + 0.4 * rng.standard_normal((n, n)))
    shifts = jnp.asarray([0.5, 3.0])
    b = jnp.asarray(rng.standard_normal((2, n)))

    def A(v):
        return jnp.einsum("ij,qj->qi", A0, v) + shifts[:, None] * v

    res = gmres(A, b, maxiter=200, reltol=1e-10, batch=True)
    for i in range(2):
        Ai = np.asarray(A0) + float(shifts[i]) * np.eye(n)
        single = gmres(
            lambda x: jnp.asarray(Ai) @ x, b[i], maxiter=200, reltol=1e-10
        )
        np.testing.assert_allclose(res.x[i], single.x, atol=1e-6)
        assert int(res.n_iterations[i]) == int(single.n_iterations)


def test_gmres_cgs_matches_mgs():
    """CGS (deal.II's own default) and MGS must agree in
    iterates AND iteration counts — scalar, batched, and multi-dim fields."""
    n = 40
    rng = np.random.default_rng(8)
    A = jnp.asarray(np.eye(n) * 4 + 0.5 * rng.standard_normal((n, n)))
    b = jnp.asarray(rng.standard_normal(n))
    r1 = gmres(lambda x: A @ x, b, maxiter=200, reltol=1e-10, orthog="cgs")
    r2 = gmres(lambda x: A @ x, b, maxiter=200, reltol=1e-10, orthog="mgs")
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-8)
    assert int(r1.n_iterations) == int(r2.n_iterations)

    # batched with a 2D per-lane field (exercises the reshape paths)
    shifts = jnp.asarray([0.3, 2.0, 7.0])
    bb = jnp.asarray(rng.standard_normal((3, 6, 8)))

    def Ab(v):
        w = jnp.einsum("ij,qjk->qik", A[:6, :6], v)
        return w + shifts[:, None, None] * v

    r1 = gmres(Ab, bb, maxiter=200, reltol=1e-10, batch=True, orthog="cgs")
    r2 = gmres(Ab, bb, maxiter=200, reltol=1e-10, batch=True, orthog="mgs")
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-8)
    assert np.array_equal(
        np.asarray(r1.n_iterations), np.asarray(r2.n_iterations)
    )


def test_chebyshev_reduces_error():
    space = make_space(2, 1, 4)
    ops = level_ops(space.fine)
    dim = 2
    a, b = 1.0, 0.1
    A = lambda u: apply_shifted(ops, a, b, u, dim)
    inv_diag = 1.0 / operator_diagonal(ops, a, b, dim)
    key = jax.random.PRNGKey(0)
    x_true = jax.random.normal(key, space.shape, dtype=jnp.float64)
    rhs = A(x_true)
    theta, delta = estimate_chebyshev_range(A, inv_diag, rhs)
    x = chebyshev_apply(A, inv_diag, theta, delta, rhs, degree=5)
    err0 = jnp.linalg.norm(x_true)
    err1 = jnp.linalg.norm(x - x_true)
    assert float(err1) < 0.6 * float(err0)


@pytest.mark.parametrize("dim,p,ref", [(2, 1, 5), (2, 2, 4), (3, 1, 3)])
def test_gmg_preconditioned_cg_iteration_counts(dim, p, ref):
    """CG + one GMG V-cycle must converge in O(10) iterations, mesh
    independent — the property the reference's gmg microbenchmark
    measures (gmg.cc:213-306)."""
    space = make_space(dim, p, ref)
    gmg = build_gmg_data(space)
    a, b = 1.0, 0.1  # like a timestep system M + tau K
    prec_state = gmg_reinit(gmg, a, b, dim)
    ops = gmg.level_ops[-1]
    A = lambda u: apply_shifted(ops, a, b, u, dim)
    key = jax.random.PRNGKey(1)
    x_true = jax.random.normal(key, space.shape, dtype=jnp.float64)
    rhs = A(x_true)
    M = lambda r: vcycle(gmg, prec_state, a, b, r, dim)
    res = pcg(A, rhs, M=M, maxiter=100, reltol=1e-10)
    np.testing.assert_allclose(res.x, x_true, atol=1e-6)
    assert int(res.n_iterations) <= 12


# refinement per (dim, degree): 15^3 / 31^2-ish grids with >= 3 levels
_VCYCLE_REF = {
    (2, 1): 5, (2, 2): 4, (2, 3): 4, (2, 4): 3,
    (3, 1): 4, (3, 2): 3, (3, 3): 3, (3, 4): 2,
}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_vcycle_cg_f32_matches_f64_iterations(dim, p):
    """V-cycle-preconditioned CG in f32 (the benchmark precision) takes
    the f64 oracle's iteration count at every degree, stage-batched like
    the schemes' inner solves.  Reduction 1e-5 (gmg_bench's f32 target)
    is two decades above f32 resolution, so both stop at the same
    iteration; the f32 solution matches to 1e-4 of its norm."""
    space = make_space(dim, p, _VCYCLE_REF[(dim, p)])
    shifts, tau = (16.0, 2.9), 0.1
    rhs = jax.random.normal(
        jax.random.PRNGKey(3), (2,) + space.shape, jnp.float64
    )
    out = {}
    for dt in (jnp.float32, jnp.float64):
        gmg = build_gmg_data(space, dtype=dt, with_dense=False)
        fine = gmg.level_ops[-1]

        @jax.jit
        def solve(a, b):
            prec = gmg_reinit(gmg, a, tau, dim, batch=True)
            A = lambda u: jax.vmap(
                lambda ai, ui: apply_shifted(fine, ai, tau, ui, dim)
            )(a, u)
            M = lambda r: vcycle(gmg, prec, a, tau, r, dim, batch=True)
            return pcg(A, b, M=M, maxiter=100, reltol=1e-5, batch=True)

        out[dt] = solve(jnp.asarray(shifts, dt), rhs.astype(dt))
    r32, r64 = out[jnp.float32], out[jnp.float64]
    assert r32.x.dtype == jnp.float32
    np.testing.assert_array_equal(r32.n_iterations, r64.n_iterations)
    assert int(jnp.max(r64.n_iterations)) <= 12
    err = jnp.linalg.norm(r32.x.astype(jnp.float64) - r64.x)
    assert float(err) <= 1e-4 * float(jnp.linalg.norm(r64.x))


def test_gmg_batched_matches_scalar():
    dim, p, ref = 2, 1, 4
    space = make_space(dim, p, ref)
    gmg = build_gmg_data(space)
    shifts = jnp.asarray([1.5, 4.0])
    tau = 0.1
    prec_b = gmg_reinit(gmg, shifts, tau, dim, batch=True)
    key = jax.random.PRNGKey(2)
    r = jax.random.normal(key, (2,) + space.shape, dtype=jnp.float64)
    out_b = vcycle(gmg, prec_b, shifts, tau, r, dim, batch=True)
    for i in range(2):
        prec_s = gmg_reinit(gmg, float(shifts[i]), tau, dim)
        out_s = vcycle(gmg, prec_s, float(shifts[i]), tau, r[i], dim)
        np.testing.assert_allclose(out_b[i], out_s, atol=1e-10)


def test_zero_rhs_robustness():
    """Zero right-hand sides must return zero in zero iterations, not NaN
    (guards the division-safety paths in the Krylov loops)."""
    n = 16
    A = jnp.eye(n) * 2.0
    z = jnp.zeros(n)
    for solver in (pcg, gmres):
        res = solver(lambda x: A @ x, z, maxiter=10, reltol=1e-8)
        assert int(res.n_iterations) == 0
        np.testing.assert_allclose(res.x, 0.0)
        assert bool(jnp.isfinite(res.x).all())


def test_batched_partial_zero_lane():
    """One lane with a zero RHS must not poison the others."""
    n = 16
    A0 = jnp.eye(n) * 3.0
    b = jnp.stack([jnp.zeros(n), jnp.ones(n)])
    res = pcg(lambda v: jnp.einsum("ij,qj->qi", A0, v), b,
              maxiter=50, reltol=1e-10, batch=True)
    assert bool(jnp.isfinite(res.x).all())
    np.testing.assert_allclose(res.x[0], 0.0)
    np.testing.assert_allclose(res.x[1], 1.0 / 3.0, rtol=1e-8)


def test_gmres_restart_matches_manual_restart_chain():
    """deal.II restart semantics: a restart recomputes the residual at the
    current iterate and starts a FRESH cycle — so gmres(restart=R) over
    3R iterations must produce exactly the iterate of three chained
    R-iteration solves, each warm-started from the previous (the compact
    huge-grid basis relies on these semantics when a solve runs past it,
    schemes/irk.py + krylov.COMPACT_BASIS)."""
    n = 40
    rng = np.random.default_rng(11)
    A = jnp.asarray(
        np.diag(np.linspace(1, 40, n)) + 0.4 * rng.standard_normal((n, n))
    )
    b = jnp.asarray(rng.standard_normal(n))
    Aop = lambda x: A @ x
    R = 4

    full = gmres(
        Aop, b, maxiter=3 * R, reltol=1e-14, restart=R, adaptive=0
    )
    assert int(full.n_iterations) == 3 * R  # actually restarted twice

    x = jnp.zeros_like(b)
    total = 0
    for _ in range(3):
        res = gmres(
            Aop, b, x0=x, maxiter=R, reltol=1e-14, restart=R, adaptive=0
        )
        x = res.x
        total += int(res.n_iterations)
    assert total == 3 * R
    np.testing.assert_allclose(full.x, x, rtol=1e-12, atol=1e-13)
