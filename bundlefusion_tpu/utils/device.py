"""The accelerator a measurement runs on: GPU or nothing.

Timing and chip checks name the device they ran on and refuse to run
anywhere else: a number taken on the CPU is never reported as a device
number, so there is no CPU fallback.
"""

from __future__ import annotations

import subprocess


def require_gpu(devices=None):
    """Return ``devices`` (default ``jax.devices()``) if they are GPUs;
    raise ``RuntimeError`` otherwise."""
    if devices is None:
        import jax

        devices = jax.devices()
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, JAX found platform {platform!r}; "
            "there is no CPU fallback"
        )
    return devices


def device_summary(devices) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi_name_power() -> str:
    """The cards' names and power limits, one line each, as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
