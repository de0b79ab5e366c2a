"""The a*M + b*K operator family on the tensor-product grid.

Parity with the reference's L3 layer:

* ``apply_shifted``   <-> ``MassLaplaceOperator::vmult(dst, src, a, b)``
  (reference ``operator.h:15-100``; matrix-free impl ``operator.h:250-460``)
* ``operator_diagonal`` <-> ``compute_inverse_diagonal`` (reference
  ``operator.h:311-329``) — exact, via Kronecker structure.
* ``apply_complex``   <-> ``ComplexMassLaplaceOperatorMatrixFree::vmult``
  (reference ``operator.h:593-666``), acting on a (re, im) pair block.
* stage-batched variants (reference ``BatchedMassLaplaceOperator``,
  ``operator.h:701-881``) are plain ``jax.vmap`` over a leading stage axis;
  see the scheme implementations.

``mode`` selects the execution strategy: ``"stencil"`` = banded
roll-and-scale sweeps (the MatrixFree analog), ``"dense"`` = dense 1D
matmul contractions (the MatrixBased analog).  Both produce
identical results; they differ only in how the work maps to hardware.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..fem.grid import Level1D
from .banded import apply_band, apply_dense_1d


class LevelOps(NamedTuple):
    """Device-resident 1D operator data for one grid level (a pytree)."""

    mass_band: jnp.ndarray  # (2p+1, m)
    stiff_band: jnp.ndarray  # (2p+1, m)
    mass_dense: jnp.ndarray | None  # (m, m); only in "dense" mode
    stiff_dense: jnp.ndarray | None  # (m, m)
    mass_diag: jnp.ndarray  # (m,)
    stiff_diag: jnp.ndarray  # (m,)

    @property
    def m(self) -> int:
        return self.mass_band.shape[1]


def level_ops(
    level: Level1D, dtype=jnp.float64, with_dense: bool = True
) -> LevelOps:
    return LevelOps(
        mass_band=jnp.asarray(level.mass_band, dtype=dtype),
        stiff_band=jnp.asarray(level.stiff_band, dtype=dtype),
        mass_dense=(
            jnp.asarray(level.mass_dense, dtype=dtype) if with_dense else None
        ),
        stiff_dense=(
            jnp.asarray(level.stiff_dense, dtype=dtype) if with_dense else None
        ),
        mass_diag=jnp.asarray(level.mass_diag, dtype=dtype),
        stiff_diag=jnp.asarray(level.stiff_diag, dtype=dtype),
    )


def _apply_1d(ops: LevelOps, which: str, u, axis: int, mode: str):
    if mode == "stencil":
        band = ops.mass_band if which == "m" else ops.stiff_band
        return apply_band(band, u, axis)
    elif mode == "dense":
        mat = ops.mass_dense if which == "m" else ops.stiff_dense
        return apply_dense_1d(mat, u, axis)
    raise ValueError(f"unknown operator mode {mode!r}")


def _spatial_axes(u_ndim: int, dim: int) -> tuple[int, ...]:
    return tuple(range(u_ndim - dim, u_ndim))


def apply_mass(ops: LevelOps, u, dim: int, mode: str = "stencil"):
    """M u = (M1 (x) ... (x) M1) u; leading axes of ``u`` are batch."""
    for ax in _spatial_axes(u.ndim, dim):
        u = _apply_1d(ops, "m", u, ax, mode)
    return u


def apply_stiffness(ops: LevelOps, u, dim: int, mode: str = "stencil"):
    """K u with K = sum_k M1 (x) .. K1(axis k) .. (x) M1."""
    axes = _spatial_axes(u.ndim, dim)
    out = None
    for k_ax in axes:
        term = _apply_1d(ops, "k", u, k_ax, mode)
        for ax in axes:
            if ax != k_ax:
                term = _apply_1d(ops, "m", term, ax, mode)
        out = term if out is None else out + term
    return out


def apply_shifted(
    ops: LevelOps,
    a,
    b,
    u,
    dim: int,
    mode: str = "stencil",
):
    """(a M + b K) u with shared 1D intermediates (4 applies in 2D, 7 in 3D).

    ``a`` / ``b`` are scalars (possibly traced); stage-batched operands
    with per-stage ``a`` use ``apply_shifted_batched`` below.
    """
    axes = _spatial_axes(u.ndim, dim)
    if dim == 2:
        ax_x, ax_y = axes
        A = _apply_1d(ops, "m", u, ax_y, mode)
        B = _apply_1d(ops, "k", u, ax_y, mode)
        out = _apply_1d(ops, "m", a * A + b * B, ax_x, mode)
        return out + b * _apply_1d(ops, "k", A, ax_x, mode)
    if dim == 3:
        ax_x, ax_y, ax_z = axes
        A = _apply_1d(ops, "m", u, ax_z, mode)
        B = _apply_1d(ops, "k", u, ax_z, mode)
        C = _apply_1d(ops, "m", A, ax_y, mode)
        D = _apply_1d(ops, "k", A, ax_y, mode)
        E = _apply_1d(ops, "m", B, ax_y, mode)
        out = _apply_1d(ops, "m", a * C + b * (D + E), ax_x, mode)
        return out + b * _apply_1d(ops, "k", C, ax_x, mode)
    raise ValueError("dim must be 2 or 3")


def apply_mass_batched(ops: LevelOps, W, dim: int, mode: str = "stencil"):
    """Stage-batched M over W (q, *spatial)."""
    return jax.vmap(lambda w: apply_mass(ops, w, dim, mode))(W)


def apply_stiffness_batched(ops: LevelOps, W, dim: int, mode: str = "stencil"):
    """Stage-batched K over W (q, *spatial)."""
    return jax.vmap(lambda w: apply_stiffness(ops, w, dim, mode))(W)


def apply_mass_stiffness_batched(
    ops: LevelOps, W, dim: int, mode: str = "stencil"
):
    """(M W, K W) over a stage block — the two ingredients of the outer
    system vmult (reference "do_reduce_number_of_vmults",
    ``main.cc:1014-1028``)."""
    return (
        apply_mass_batched(ops, W, dim, mode),
        apply_stiffness_batched(ops, W, dim, mode),
    )


def apply_shifted_batched(
    ops: LevelOps,
    a_vec,
    b,
    W,
    dim: int,
    mode: str = "stencil",
):
    """Per-stage (a_i M + b K) W_i — the reference's batched operator
    (``operator.h:701-881``).  ``a_vec``: (q,), ``W``: (q, *spatial)."""
    return jax.vmap(
        lambda ai, wi: apply_shifted(ops, ai, b, wi, dim, mode)
    )(a_vec, W)


def apply_complex(
    ops: LevelOps, d_re, d_im, tau, z, dim: int, mode: str = "stencil"
):
    """2x2 real-block form of ((d_re + i d_im) M + tau K) on z = (re, im).

    ``z`` has shape ``(2, *spatial)``.  Mirrors the fused complex cell loop
    at reference ``operator.h:616-660``:

        out_re = d_re M re - d_im M im + tau K re
        out_im = d_im M re + d_re M im + tau K im
    """
    s = apply_shifted(ops, d_re, tau, z, dim, mode)  # batch over (re, im)
    mz = apply_mass(ops, z, dim, mode)
    cross = jnp.stack([-d_im * mz[1], d_im * mz[0]])
    return s + cross


def operator_diagonal(ops: LevelOps, a, b, dim: int):
    """Exact diagonal of a*M + b*K from the 1D diagonals.

    Replaces ``MatrixFreeTools::compute_diagonal`` (reference
    ``operator.h:311-329``): diag(M) and diag(K) are outer products /
    Kronecker sums of the 1D diagonals.
    """
    dm, dk = ops.mass_diag, ops.stiff_diag
    if dim == 2:
        mass_d = dm[:, None] * dm[None, :]
        stiff_d = dk[:, None] * dm[None, :] + dm[:, None] * dk[None, :]
    elif dim == 3:
        mass_d = dm[:, None, None] * dm[None, :, None] * dm[None, None, :]
        stiff_d = (
            dk[:, None, None] * dm[None, :, None] * dm[None, None, :]
            + dm[:, None, None] * dk[None, :, None] * dm[None, None, :]
            + dm[:, None, None] * dm[None, :, None] * dk[None, None, :]
        )
    else:
        raise ValueError("dim must be 2 or 3")
    return a * mass_d + b * stiff_d
