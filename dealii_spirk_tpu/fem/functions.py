"""Manufactured solution and forcing of the heat-equation benchmark.

Mirrors the reference's ``AnalyticalSolution`` / ``RightHandSide``
(reference ``main.cc:3495-3602``, with ``const_wave = true`` so the wave
numbers are ``a_x = a_y = a_z = 2``):

    u(x, t)  = prod_k sin(a pi x_k) * (1 + sin(pi c_t t)) * exp(-a_t t)
    f(x, t)  = prod_k sin(a pi x_k) * g(t)
    g(t)     = [pi c_t cos(pi c_t t) - a_t (1 + sin(pi c_t t))
                + dim a^2 pi^2 (1 + sin(pi c_t t))] * exp(-a_t t)

with ``a_t = 0.5``, ``c_t = 1``, solving u_t = laplace(u) + f with
homogeneous Dirichlet BCs.  The space/time separability is exact, which this
build exploits: the spatial load vector is assembled once and the
per-stage RHS evaluation becomes a scalar multiply (instead of the
reference's per-call cell-loop assembly at ``main.cc:3213-3219``).
"""

from __future__ import annotations

import jax.numpy as jnp

A_T = 0.5
C_T = 1.0
WAVE = 2.0  # const_wave => a_x = a_y = a_z = 2 (reference main.cc:3502-3504)
PI = float(jnp.pi)


def solution_time_factor(t):
    """Time factor of the analytical solution."""
    return (1.0 + jnp.sin(PI * C_T * t)) * jnp.exp(-A_T * t)


def rhs_time_factor(t, dim: int):
    """Time factor g(t) of the separable forcing f = S(x) g(t)."""
    s = jnp.sin(PI * C_T * t)
    return (
        PI * C_T * jnp.cos(PI * C_T * t)
        - A_T * (1.0 + s)
        + dim * WAVE**2 * PI**2 * (1.0 + s)
    ) * jnp.exp(-A_T * t)
