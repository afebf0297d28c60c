"""The GPU that a measurement runs on.

A measurement names its device and refuses to fall back to the CPU:
``require_gpu`` raises unless JAX's default backend is a GPU, and
``describe_gpu`` reads each card's name and power limit from
``nvidia-smi`` (a card set below its maximum power runs slower under
load, so a number means little without it).
"""

from __future__ import annotations

import subprocess

import jax

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def require_gpu() -> dict:
    """``device_summary()``; raises RuntimeError unless it is a GPU."""
    summary = device_summary()
    if summary["platform"] != "gpu":
        raise RuntimeError(
            f"a GPU is required; JAX found {summary['platform']} "
            f"({summary['kind']})")
    return summary


def parse_gpu_csv(text: str) -> list[tuple[str, str]]:
    """``[(name, power_limit)]`` from ``NVIDIA_SMI_QUERY`` output, one
    entry per card, e.g. ``("NVIDIA H100 80GB HBM3", "700.00 W")``."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, power = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), power.strip()))
    return cards


def describe_gpu() -> str:
    """One line naming every card and its power limit, as ``nvidia-smi``
    reports them."""
    out = subprocess.run(NVIDIA_SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return "gpu: " + "; ".join(f"{name}, {power}"
                               for name, power in parse_gpu_csv(out))
