"""Config parsing parity tests (reference main.cc:2943-3010)."""

import json

import pytest

from dealii_spirk_tpu.config import Parameters


def test_defaults_match_reference():
    p = Parameters()
    assert p.fe_degree == 4
    assert p.n_refinements == 5
    assert p.time_integration_scheme == "ost"
    assert p.end_time == 0.5
    assert p.time_step_size == 0.1
    assert p.irk_stages == 3
    assert p.operator_type == "MatrixBased"
    assert p.block_preconditioner_type == "AMG"
    assert p.outer_tolerance == 1e-8
    assert p.inner_tolerance == 1e-6
    assert p.padding == -1
    assert p.do_output_paraview is True


def test_reference_json_configs_parse(tmp_path):
    """The reference's json configs (string-typed numbers and all) load."""
    cfg = {
        "FEDegree": 1,
        "NRefinements": 7,
        "TimeIntegrationScheme": "spirk",
        "IRKStages": "5",
        "TimeStepSize": "0.1",
        "EndTime": "0.5",
        "OperatorType": "MatrixFree",
        "BlockPreconditionerType": "GMG",
        "InnerTolerance": 0.0,
    }
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps(cfg))
    p = Parameters.from_json(str(f), dim=3)
    assert p.irk_stages == 5
    assert p.time_step_size == 0.1
    assert p.is_stage_parallel
    assert p.stage_axis_size == 5


def test_repo_json_configs_parse():
    import glob
    import os

    paths = glob.glob(
        os.path.join(os.path.dirname(__file__), "..", "json", "*.json")
    )
    assert len(paths) >= 9
    for path in paths:
        Parameters.from_json(path, dim=3)


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        Parameters.from_dict({"NoSuchKey": 1})


def test_invalid_scheme_rejected():
    with pytest.raises(ValueError):
        Parameters.from_dict({"TimeIntegrationScheme": "rk4"})


def test_pallas_operator_mode_rejected():
    """The fused Pallas kernels are gone; asking for them is an error,
    not a silent fallback."""
    with pytest.raises(ValueError, match="OperatorMode 'pallas'"):
        Parameters.from_dict({"OperatorMode": "pallas"})
    for mode, expect in (("", "stencil"), ("stencil", "stencil"),
                         ("dense", "dense")):
        p = Parameters.from_dict(
            {"OperatorType": "MatrixFree", "OperatorMode": mode,
             "Precision": "f32"}
        )
        assert p.operator_mode == expect


def test_stage_axis_sizes():
    assert (
        Parameters.from_dict(
            {"TimeIntegrationScheme": "complex_spirk", "IRKStages": 5}
        ).stage_axis_size
        == 3
    )
    assert (
        Parameters.from_dict(
            {"TimeIntegrationScheme": "irk", "IRKStages": 5}
        ).stage_axis_size
        == 1
    )


def test_sweep_generators(tmp_path, monkeypatch):
    import subprocess
    import sys
    import os

    script = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "sweeps.py"
    )
    out = subprocess.run(
        [sys.executable, script, "p", "--outdir", str(tmp_path)],
        capture_output=True,
        text=True,
    )
    assert out.returncode == 0, out.stderr
    files = list(tmp_path.glob("input_*.json"))
    assert len(files) == 8
    for f in files:
        Parameters.from_dict(json.loads(f.read_text()))


def test_generated_sweep_config_runs(tmp_path):
    """A file produced by the sweep generator must run end-to-end (the
    reference's scripts feed irk-3D the same way)."""
    import subprocess
    import sys
    import os

    script = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "sweeps.py"
    )
    subprocess.run(
        [sys.executable, script, "q", "--outdir", str(tmp_path)],
        check=True,
        capture_output=True,
    )
    from dealii_spirk_tpu.runner import run_config

    # input_0000: refinement 3, q=2, irk — small enough for CPU f64
    p = Parameters.from_json(str(tmp_path / "input_0000.json"), dim=3)
    assert p.n_refinements == 3 and p.irk_stages == 2
    p.end_time = 0.2  # trim the sweep's T=1.0 for test runtime
    out = run_config(p, verbose=False)
    assert out["error_L2"] < 0.2
    assert out["n_outer"] > 0
