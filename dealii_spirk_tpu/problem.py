"""The heat-equation benchmark problem: state, forcing, errors.

Counterpart of ``HeatEquation::Problem`` (reference
``main.cc:3014-3603``).  The separable structure of the manufactured
solution is exploited throughout:

* initial condition = outer product of 1D sine samples at the interior
  nodes (nodal interpolation, like ``VectorTools::interpolate`` at
  reference ``main.cc:3301-3303``),
* the load vector is ``F(t) = g(t) * F0`` with a *precomputed* spatial
  load tensor ``F0`` — one scalar-tensor multiply replaces the reference's
  per-stage assembly sweep (``create_right_hand_side`` with QGauss(p+1),
  reference ``main.cc:3213-3219``),
* L2/Linf errors integrate ``(u_h - u)^2`` with QGauss(p+2) on the tensor
  quadrature grid (reference ``main.cc:3436-3469``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import Parameters
from .fem.functions import WAVE, rhs_time_factor, solution_time_factor
from .fem.grid import Space, make_space
from .ops.banded import apply_dense_1d


def _outer(vecs):
    out = vecs[0]
    for v in vecs[1:]:
        out = jnp.tensordot(out, v, axes=0)
    return out


class HeatProblem:
    """Device-resident problem data for one (dim, degree, refinement)."""

    def __init__(self, params: Parameters):
        self.params = params
        self.space: Space = make_space(
            params.dim, params.fe_degree, params.n_refinements
        )
        self.dtype = jnp.float64 if params.precision == "f64" else jnp.float32
        sp = self.space
        dim = sp.dim

        sin_nodes = jnp.asarray(
            np.sin(WAVE * np.pi * sp.fine.x), dtype=self.dtype
        )
        self.u0 = _outer([sin_nodes] * dim)

        # spatial load factor per axis: integral of sin(a pi x) against the
        # interior basis with QGauss(p+1).  Only the 1D factor is stored;
        # the dim-D outer product is built lazily inside traced functions
        # (``load``) — capturing the full m^dim tensor as an HLO constant
        # inflates compiled programs by q*m^3*4 bytes (66 MB at
        # refinement 8), slowing compilation and wasting device memory.
        f1 = sp.rhs_eval.T @ (sp.rhs_wq * np.sin(WAVE * np.pi * sp.rhs_xq))
        self._load_1d = jnp.asarray(f1, dtype=self.dtype)

        # error machinery (QGauss(p+2))
        self._E = jnp.asarray(sp.err_eval, dtype=self.dtype)
        self._wq = jnp.asarray(sp.err_wq, dtype=self.dtype)
        self._sinq = jnp.asarray(
            np.sin(WAVE * np.pi * sp.err_xq), dtype=self.dtype
        )
        self._errors_jit = jax.jit(self._errors)

    @property
    def load(self):
        """Spatial load tensor F0 (separable outer product; eager use
        only — inside jit use ``stage_load`` so the m^dim tensor is built
        in-graph instead of being embedded as a constant)."""
        return _outer([self._load_1d] * self.space.dim)

    def stage_load(self, tf):
        """(len(tf), *spatial) per-stage load block ``tf_i * F0``.

        ``tf`` is traced (it depends on t), so the chained outer products
        stay in the compiled graph — only the (m,) 1D factor is a
        constant.  XLA fuses the broadcast-multiplies into the consumer.
        """
        out = tf[:, None] * self._load_1d[None]
        for _ in range(self.space.dim - 1):
            out = jnp.tensordot(out, self._load_1d, axes=0)
        return out

    def rhs(self, t):
        """Assembled load vector at time t (traced-friendly; the m^dim
        tensor is built in-graph via ``stage_load``)."""
        tf = rhs_time_factor(t, self.space.dim).astype(self.dtype)
        return self.stage_load(jnp.atleast_1d(tf))[0]

    def initial_condition(self):
        return self.u0

    def _errors(self, u, t):
        dim = self.space.dim
        uq = u
        for ax in range(dim):
            uq = apply_dense_1d(self._E, uq, ax)
        exact = _outer([self._sinq] * dim) * solution_time_factor(t)
        diff = uq - exact
        sq = diff * diff
        for ax in reversed(range(dim)):
            sq = jnp.tensordot(sq, self._wq, axes=((ax,), (0,)))
        return jnp.sqrt(sq), jnp.max(jnp.abs(diff))

    def errors(self, u, t) -> tuple[float, float]:
        """(L2, Linf) error against the analytical solution at time t."""
        l2, linf = self._errors_jit(u, jnp.asarray(t, dtype=self.dtype))
        return float(l2), float(linf)

    @functools.cached_property
    def n_dofs(self) -> int:
        return self.space.n_dofs
