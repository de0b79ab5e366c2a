"""Operator layer: separable tensor-product applications of a*M + b*K.

This is the replacement of the reference's L3 operator layer
(``include/operator.h``): instead of a sum-factorization cell loop over an
unstructured mesh, the uniform tensor-product grid lets every operator act
as a chain of 1D banded (stencil) or dense (einsum) applications along each
spatial axis — both fuse well under XLA and vectorize trivially over a
leading stage/batch axis (the reference's "batched" operator,
``operator.h:701-881``, is just ``jax.vmap`` here).
"""

from .banded import apply_band, apply_dense_1d
from .mass_laplace import (
    LevelOps,
    apply_complex,
    apply_mass,
    apply_mass_batched,
    apply_mass_stiffness_batched,
    apply_shifted,
    apply_shifted_batched,
    apply_stiffness,
    apply_stiffness_batched,
    level_ops,
    operator_diagonal,
)
from .transfer import prolong, restrict

__all__ = [
    "apply_band",
    "apply_dense_1d",
    "LevelOps",
    "level_ops",
    "apply_mass",
    "apply_mass_batched",
    "apply_mass_stiffness_batched",
    "apply_stiffness",
    "apply_stiffness_batched",
    "apply_shifted",
    "apply_shifted_batched",
    "apply_complex",
    "operator_diagonal",
    "prolong",
    "restrict",
]
