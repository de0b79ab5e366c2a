"""Every scheme in f32 against its own f64 run (the benchmark precision
against the oracle precision), on the stencil path that the GPU runs; 3D
here, 2D in ``test_f32_schemes_2d.py`` (two files so the test workers
share the load).

Oracle: per-step outer iteration counts equal, and L2 error within
``L2_RTOL`` relative.  At refinement 3 the discretization error (~1e-2)
dwarfs f32 rounding of the solution (~1e-6 of it after the cond(T)
amplification of the stage basis change), so 1e-4 holds with a wide
margin while still catching any f32-only defect in the solve.
"""

import numpy as np
import pytest

from dealii_spirk_tpu.config import SCHEMES, Parameters
from dealii_spirk_tpu.runner import run_config

L2_RTOL = 1e-4

BASE = {
    "FEDegree": 1,
    "NRefinements": 3,
    "IRKStages": 4,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-4,
    "DoOutputParaview": False,
}


def _run(scheme, precision, dim):
    p = Parameters.from_dict(
        {**BASE, "TimeIntegrationScheme": scheme, "Precision": precision},
        dim=dim,
    )
    return run_config(p, verbose=False)


def check_f32_matches_f64(scheme, dim):
    f32 = _run(scheme, "f32", dim)
    f64 = _run(scheme, "f64", dim)
    assert f32["u"].dtype == np.float32 and f64["u"].dtype == np.float64
    assert f32["outer_per_step"] == f64["outer_per_step"]
    assert len(f64["outer_per_step"]) == 2
    np.testing.assert_allclose(f32["error_L2"], f64["error_L2"], rtol=L2_RTOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_f32_matches_f64_3d(scheme):
    check_f32_matches_f64(scheme, 3)
