"""The accelerator a measurement runs on, named in every record.

A measurement path that finds no GPU fails: it never falls back to the CPU,
whose times would be read as the card's.
"""

from __future__ import annotations

import subprocess

import jax


def device_info() -> dict:
    """platform, device_kind and device count as JAX reports them."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """:func:`device_info`, or RuntimeError when JAX's default device is not
    a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            "no GPU: JAX's default platform is %r; this path measures or "
            "checks the card and has no fallback" % info["platform"]
        )
    return info


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them.  A plain
    subprocess: it does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
