"""1D banded / dense operator applications along an axis of an nd array.

The banded form computes ``out = sum_k w_k * roll(u, -k, axis)`` where
``w_k[i] = Op[i, i+k]`` — a shifted-diagonal (stencil) formulation that
XLA fuses into a single bandwidth-bound sweep and that the SPMD
partitioner turns into halo exchanges when ``axis`` is sharded.  Entries
wrapped around by ``roll`` are annihilated by the zero band weights at the
boundary rows, so no masking is needed.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _wshape(ndim: int, axis: int, m: int) -> tuple[int, ...]:
    shape = [1] * ndim
    shape[axis] = m
    return tuple(shape)


def apply_band(band, u, axis: int):
    """Apply a banded 1D operator along ``axis`` of ``u``.

    ``band`` has shape ``(2p+1, m)`` with ``band[p+k, i] = Op[i, i+k]``.
    """
    p = (band.shape[0] - 1) // 2
    m = band.shape[1]
    shape = _wshape(u.ndim, axis, m)
    out = band[p].reshape(shape) * u
    for k in range(1, p + 1):
        out = out + band[p + k].reshape(shape) * jnp.roll(u, -k, axis)
        out = out + band[p - k].reshape(shape) * jnp.roll(u, k, axis)
    return out


def apply_dense_1d(mat, u, axis: int):
    """Apply a dense 1D operator ``mat`` (n_out, n_in) along ``axis``.

    Contracts the axis in place with ``dot_general`` rather than
    moveaxis + matmul, which XLA can materialize as a layout copy of the
    whole field before the matmul."""
    axis = axis % u.ndim
    out = lax.dot_general(
        mat, u, (((1,), (axis,)), ((), ())), precision="highest"
    )
    return jnp.moveaxis(out, 0, axis)
