"""Structured-grid finite-element core.

The reference builds on deal.II's unstructured-mesh machinery
(``parallel::distributed::Triangulation`` + ``DoFHandler`` + ``MatrixFree``,
reference ``main.cc:3020-3041``).  Because the problem domain is always a
globally refined hypercube (reference ``main.cc:3038-3039`` — no adaptivity,
no hanging nodes), the representation here is a *tensor-product grid*:
the global Q_p basis is an outer product of 1D bases, so every operator
(mass, stiffness, prolongation, quadrature evaluation) factorizes into
separable 1D banded applications.  That turns the FEM hot loop into
XLA-friendly fused stencil sweeps instead of an unstructured cell loop.
"""

from .basis import gauss_legendre_01, gauss_lobatto_01, lagrange_matrix
from .grid import Level1D, Space, make_level, make_space

__all__ = [
    "gauss_legendre_01",
    "gauss_lobatto_01",
    "lagrange_matrix",
    "Level1D",
    "Space",
    "make_level",
    "make_space",
]
