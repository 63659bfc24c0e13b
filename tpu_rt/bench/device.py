"""The device a measurement runs on.

A measurement needs the GPU: `require_gpu` stops the program when JAX
found none, so no CPU number is ever reported under a device metric.
`card_info` reads the card's name and power limit, which go beside every
number kept (a card set below its power limit runs slower under load).
"""

from __future__ import annotations

import subprocess
import sys


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` lines, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def device_summary() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(program: str) -> dict:
    """Exit with code 2 unless JAX runs on a GPU; returns device_summary()."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        print(f"{program}: needs an NVIDIA GPU, JAX found {dev}",
              file=sys.stderr)
        sys.exit(2)
    return dev
