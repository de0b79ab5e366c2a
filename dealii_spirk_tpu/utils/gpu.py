"""The GPU gate and card description shared by ``bench.py`` and
``chip_smoke.py``: both measure the card and must fail, not fall back to
the CPU, when JAX finds no GPU."""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = (
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
)


class NoGPUError(RuntimeError):
    """JAX's default backend is not a GPU."""


def require_gpu(devices=None, n_min: int = 1):
    """Return JAX's device list when it holds at least ``n_min`` GPUs."""
    if devices is None:
        import jax

        devices = jax.devices()
    if not devices or devices[0].platform != "gpu":
        raise NoGPUError(f"no GPU: JAX's devices are {list(devices)}")
    if len(devices) < n_min:
        raise NoGPUError(f"need {n_min} GPUs, JAX found {len(devices)}")
    return devices


def device_summary(devices) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``(name, power_limit)`` per card from the query's csv lines."""
    rows = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line {line!r}")
        rows.append((name.strip(), limit.strip()))
    if not rows:
        raise ValueError("nvidia-smi listed no card")
    return rows


def card_lines() -> list[str]:
    """The query's output lines, one per card, as nvidia-smi gives them;
    raises when the query fails or lists no card."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout
    parse_nvidia_smi(out)
    return out.strip().splitlines()
