"""The card a run names (frozen from the port's benchmarks/common.py
``device_info``): its name, and its power limit as nvidia-smi reads it."""

from __future__ import annotations

import subprocess

import torch


def device_info(dev: torch.device) -> dict:
    """{"device": the card's name (or "cpu"), "power_limit_w": its power
    limit (None on the CPU or where nvidia-smi gives none)}."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    watts = None
    if "," in line:
        field = line.rsplit(",", 1)[1].strip().split()
        try:
            watts = float(field[0])
        except (IndexError, ValueError):
            watts = None
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit_w": watts}


__all__ = ["device_info"]
