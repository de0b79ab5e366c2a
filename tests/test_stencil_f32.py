"""f32 stencil applies against the f64 dense-Kronecker oracle.

The XLA stencil path (``ops/banded.py`` roll sweeps) is the only
MatrixFree path, and the benchmark runs it in f32 at every degree.  Each
operator is applied in f32 to an f32 input and compared with the f64
Kronecker-product matrix applied to the same (f32-rounded) input.

Tolerance: every output entry is a sum of at most (2p+1)^dim products,
formed as dim successive one-axis sweeps of 2p+1 terms each, so its f32
rounding error is at most about dim * (2p+1) * eps32 * (|Op| |u|)_i,
below 5e-6 (|Op| |u|)_i for p <= 4.  The check is entrywise against
2e-5 (|Op| |u|)_i, a 4x margin.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from dealii_spirk_tpu.fem.grid import make_level
from dealii_spirk_tpu.ops import (
    apply_complex,
    apply_mass,
    apply_mass_stiffness_batched,
    apply_shifted,
    apply_shifted_batched,
    apply_stiffness,
    level_ops,
)

RTOL = 2e-5
# refinement per (degree, dim): m^dim <= ~1400 keeps the dense oracle small
REFINEMENT = {
    (1, 2): 4, (2, 2): 3, (3, 2): 3, (4, 2): 3,
    (1, 3): 3, (2, 3): 2, (3, 3): 2, (4, 3): 1,
}
A_SHIFT, B_SHIFT = 1.7, 0.3
STAGE_SHIFTS = (16.0, 5.644, 3.162)
D_RE, D_IM, TAU = 1.3, 0.7, 0.1


@functools.lru_cache(maxsize=None)
def _oracle(p: int, dim: int):
    """(level, M, K) with M, K the f64 dim-D Kronecker matrices."""
    level = make_level(REFINEMENT[(p, dim)], p)
    M1, K1 = level.mass_dense, level.stiff_dense
    M, K = M1, K1
    for _ in range(dim - 1):
        M, K = np.kron(M, M1), np.kron(K, M1) + np.kron(M, K1)
    return level, M, K


def _check(out, Op, u):
    """Entrywise ``|out - Op u| <= RTOL (|Op| |u|)`` in f64."""
    assert out.dtype == jnp.float32
    out = np.asarray(out, np.float64).ravel()
    u = np.asarray(u, np.float64).ravel()
    ref = Op @ u
    bound = RTOL * (np.abs(Op) @ np.abs(u)) + 1e-30
    worst = np.max(np.abs(out - ref) / bound)
    assert worst <= 1.0, f"error {worst:.2f}x the f32 bound"


def _field(rng, shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


OPS = (
    "mass",
    "stiffness",
    "shifted",
    "shifted_batched",
    "mass_stiffness_batched",
    "complex",
)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_f32_stencil_apply_vs_f64_kron(p, dim, op):
    level, M, K = _oracle(p, dim)
    ops = level_ops(level, jnp.float32, with_dense=False)
    spatial = (level.m,) * dim
    rng = np.random.default_rng(100 * p + 10 * dim + OPS.index(op))
    if op == "mass":
        u = _field(rng, spatial)
        _check(apply_mass(ops, u, dim), M, u)
    elif op == "stiffness":
        u = _field(rng, spatial)
        _check(apply_stiffness(ops, u, dim), K, u)
    elif op == "shifted":
        u = _field(rng, spatial)
        out = apply_shifted(ops, A_SHIFT, B_SHIFT, u, dim)
        _check(out, A_SHIFT * M + B_SHIFT * K, u)
    elif op == "shifted_batched":
        W = _field(rng, (len(STAGE_SHIFTS),) + spatial)
        shifts = jnp.asarray(STAGE_SHIFTS, jnp.float32)
        out = apply_shifted_batched(ops, shifts, TAU, W, dim)
        for i, a in enumerate(STAGE_SHIFTS):
            _check(out[i], a * M + TAU * K, W[i])
    elif op == "mass_stiffness_batched":
        W = _field(rng, (3,) + spatial)
        MW, KW = apply_mass_stiffness_batched(ops, W, dim)
        for i in range(3):
            _check(MW[i], M, W[i])
            _check(KW[i], K, W[i])
    else:
        z = _field(rng, (2,) + spatial)
        out = apply_complex(ops, D_RE, D_IM, TAU, z, dim)
        # 2x2 real block form: [[d_re M + tau K, -d_im M], [d_im M, ...]]
        S = D_RE * M + TAU * K
        Op = np.block([[S, -D_IM * M], [D_IM * M, S]])
        _check(out, Op, z)
