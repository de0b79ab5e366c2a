"""CPU tests of what ``chip_smoke.py`` and ``bench.py`` decide before
they reach the card: the GPU gate, the card line, the compile cache
directory, the phase selection and the last line."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from dealii_spirk_tpu.utils import compile_cache  # noqa: E402
from dealii_spirk_tpu.utils.gpu import (  # noqa: E402
    NoGPUError,
    device_summary,
    parse_nvidia_smi,
    require_gpu,
)


def _gpus(n):
    return [
        SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
        for _ in range(n)
    ]


def test_gate_refuses_cpu_backend():
    with pytest.raises(NoGPUError, match="no GPU"):
        require_gpu()  # the test session runs on the CPU backend
    with pytest.raises(NoGPUError):
        require_gpu(jax.devices("cpu"))


def test_gate_accepts_gpus_and_counts_them():
    assert len(require_gpu(_gpus(1))) == 1
    assert len(require_gpu(_gpus(4), n_min=4)) == 4
    with pytest.raises(NoGPUError, match="need 4 GPUs"):
        require_gpu(_gpus(1), n_min=4)
    with pytest.raises(NoGPUError):
        require_gpu([])


def test_last_line_format():
    line = chip_smoke.final_line(_gpus(1))
    assert json.loads(line) == {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": "NVIDIA H100 80GB HBM3",
            "count": 1,
        },
    }
    assert "\n" not in line
    assert device_summary(_gpus(4))["count"] == 4


@pytest.mark.parametrize(
    "text,expected",
    [
        (
            "NVIDIA H100 80GB HBM3, 700.00 W\n",
            [("NVIDIA H100 80GB HBM3", "700.00 W")],
        ),
        (
            "NVIDIA H100 80GB HBM3, 400.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
            [
                ("NVIDIA H100 80GB HBM3", "400.00 W"),
                ("NVIDIA H100 80GB HBM3", "700.00 W"),
            ],
        ),
        ("NVIDIA H100 PCIe, [N/A]", [("NVIDIA H100 PCIe", "[N/A]")]),
    ],
)
def test_nvidia_smi_parser(text, expected):
    assert parse_nvidia_smi(text) == expected


@pytest.mark.parametrize("text", ["", "no comma here", ", 700.00 W"])
def test_nvidia_smi_parser_rejects_malformed(text):
    with pytest.raises(ValueError):
        parse_nvidia_smi(text)


def test_cache_dir_from_environment(tmp_path):
    env = {compile_cache.ENV_VAR: str(tmp_path)}
    assert compile_cache.compile_cache_dir(env) == str(tmp_path)


def test_cache_dir_default_is_fixed_checkout_path():
    path = compile_cache.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert compile_cache.compile_cache_dir({}) == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_leaves_set_variable_to_jax(
    monkeypatch, tmp_path
):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_phase_selection():
    default = chip_smoke.phases(chip_smoke.parse_args([]))
    assert default == (chip_smoke.phase_oracle, chip_smoke.phase_main)
    four = chip_smoke.phases(chip_smoke.parse_args(["--four"]))
    assert four == (chip_smoke.phase_four,)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_fail_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    cannot import the program and exits non-zero with no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
