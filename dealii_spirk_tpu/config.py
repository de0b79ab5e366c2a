"""Run configuration with reference-compatible JSON schema.

The key names, defaults and validation mirror ``HeatEquation::Parameters``
(reference ``main.cc:2943-3010``) so the reference's ``json/`` configs run
unmodified.  A few extensions are accepted on top (``Precision``,
``Dim``, ``OperatorMode``) — unknown keys raise, like deal.II's
ParameterHandler.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

SCHEMES = (
    "ost",
    "irk",
    "irk_batched",
    "spirk",
    "complex_irk",
    "complex_irk_batched",
    "complex_spirk",
    "complex_spirk_batched",
)

_KEY_MAP = {
    "FEDegree": ("fe_degree", int),
    "NRefinements": ("n_refinements", int),
    "TimeIntegrationScheme": ("time_integration_scheme", str),
    "EndTime": ("end_time", float),
    "TimeStepSize": ("time_step_size", float),
    "IRKStages": ("irk_stages", int),
    "OuterTolerance": ("outer_tolerance", float),
    "InnerTolerance": ("inner_tolerance", float),
    "OperatorType": ("operator_type", str),
    "BlockPreconditionerType": ("block_preconditioner_type", str),
    "UseSharedMemory": ("use_sm", bool),
    "DoRowMajor": ("do_row_major", bool),
    "Padding": ("padding", int),
    "MaxRanks": ("max_ranks", int),
    "DoOutputParaview": ("do_output_paraview", bool),
    # extensions (not present in the reference)
    "Precision": ("precision", str),
    "Dim": ("dim", int),
    "OperatorMode": ("operator_mode_override", str),
}


@dataclass
class Parameters:
    """Defaults match reference ``main.cc:2945-2967``."""

    fe_degree: int = 4
    n_refinements: int = 5
    time_integration_scheme: str = "ost"
    end_time: float = 0.5
    time_step_size: float = 0.1
    irk_stages: int = 3
    do_reduce_number_of_vmults: bool = True
    operator_type: str = "MatrixBased"
    block_preconditioner_type: str = "AMG"
    use_sm: bool = False
    do_row_major: bool = True
    padding: int = -1
    max_ranks: int = 0
    outer_tolerance: float = 1e-8
    inner_tolerance: float = 1e-6
    do_output_paraview: bool = True
    # extensions
    precision: str = "f64"
    dim: int = 3
    operator_mode_override: str = ""

    @classmethod
    def from_dict(cls, raw: dict, dim: int | None = None) -> "Parameters":
        p = cls()
        for key, value in raw.items():
            if key not in _KEY_MAP:
                raise KeyError(f"unknown parameter {key!r}")
            name, typ = _KEY_MAP[key]
            if typ is bool and isinstance(value, str):
                value = value.lower() in ("true", "1", "yes")
            elif typ is bool:
                value = bool(value)
            else:
                value = typ(value)
            setattr(p, name, value)
        if dim is not None:
            p.dim = dim
        p.validate()
        return p

    @classmethod
    def from_json(cls, path: str, dim: int | None = None) -> "Parameters":
        with open(path) as f:
            return cls.from_dict(json.load(f), dim=dim)

    def validate(self) -> None:
        if self.time_integration_scheme not in SCHEMES:
            raise ValueError(
                f"unknown scheme {self.time_integration_scheme!r}; "
                f"expected one of {SCHEMES}"
            )
        if self.operator_type not in ("MatrixBased", "MatrixFree"):
            raise ValueError(f"unknown OperatorType {self.operator_type!r}")
        if self.block_preconditioner_type not in ("AMG", "GMG"):
            raise ValueError(
                f"unknown BlockPreconditionerType "
                f"{self.block_preconditioner_type!r}"
            )
        if self.precision not in ("f32", "f64"):
            raise ValueError(f"unknown Precision {self.precision!r}")
        if self.operator_mode_override not in ("", "stencil", "dense"):
            raise ValueError(
                f"unknown OperatorMode {self.operator_mode_override!r}; "
                "expected 'stencil' or 'dense' (the fused Pallas kernels "
                "were removed: MatrixFree runs the XLA stencil path)"
            )
        if self.dim not in (2, 3):
            raise ValueError("Dim must be 2 or 3")

    @property
    def operator_mode(self) -> str:
        """Map the reference's OperatorType onto the execution modes:
        MatrixBased -> dense 1D matmul contractions; MatrixFree -> banded
        roll sweeps (``ops/banded.py``), the same path on every backend
        and degree."""
        if self.operator_mode_override:
            return self.operator_mode_override
        if self.operator_type == "MatrixBased":
            return "dense"
        return "stencil"

    @property
    def is_stage_parallel(self) -> bool:
        return "spirk" in self.time_integration_scheme

    @property
    def is_batched(self) -> bool:
        return self.time_integration_scheme.endswith("_batched")

    @property
    def stage_axis_size(self) -> int:
        """Extent of the stage mesh axis (reference ``main.cc:3660-3666``):
        q for spirk, ceil(q/2) for complex_spirk, 1 otherwise."""
        if self.time_integration_scheme == "spirk":
            return self.irk_stages
        if self.time_integration_scheme.startswith("complex_spirk"):
            return (self.irk_stages + 1) // 2
        return 1

    def auto_time_step(self, dx: float) -> float:
        """dt = dx^((p+1)/(2q-1)) when TimeStepSize <= 0 (reference
        ``main.cc:3314-3318``)."""
        if self.time_step_size > 0.0:
            return self.time_step_size
        return dx ** ((self.fe_degree + 1.0) / (2.0 * self.irk_stages - 1.0))
