"""2D half of ``test_f32_schemes.py``: every scheme in f32 against its
own f64 run."""

import pytest

from dealii_spirk_tpu.config import SCHEMES
from test_f32_schemes import check_f32_matches_f64


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_f32_matches_f64_2d(scheme):
    check_f32_matches_f64(scheme, 2)
