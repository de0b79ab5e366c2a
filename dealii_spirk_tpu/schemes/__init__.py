"""Time-integration schemes (the reference's L5 layer, main.cc:450-2937).

Scheme selection parity (reference ``main.cc:3221-3293``):

========================  =====================================================
name                      realization here
========================  =====================================================
ost                       Crank–Nicolson, CG + GMG (``ost.py``)
irk / irk_batched         q-stage Radau IIA, outer GMRES, T-diagonalized
                          per-stage shifted GMG solves, stage axis = vmap
                          (``irk.py``)
spirk                     same mathematics, stage axis on a device-mesh axis
                          (``irk.py`` + ``parallel/``)
complex_irk(_batched)     exact complex diagonalization, per-eigenpair GMRES
                          with PRESB / block-GMG preconditioning
                          (``complex_irk.py``)
complex_spirk(_batched)   pair axis on a device-mesh axis
========================  =====================================================
"""

from __future__ import annotations

from ..config import Parameters
from ..problem import HeatProblem


def make_scheme(problem: HeatProblem, params: Parameters, mesh=None):
    name = params.time_integration_scheme
    if name == "ost":
        from .ost import OneStepTheta

        return OneStepTheta(problem, params)
    if name in ("irk", "irk_batched", "spirk"):
        from .irk import IRK

        return IRK(problem, params, mesh=mesh)
    if name in (
        "complex_irk",
        "complex_irk_batched",
        "complex_spirk",
        "complex_spirk_batched",
    ):
        from .complex_irk import ComplexIRK

        return ComplexIRK(problem, params, mesh=mesh)
    raise ValueError(f"unknown scheme {name!r}")
