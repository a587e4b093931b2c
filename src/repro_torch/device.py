"""Device resolution and card identity for the port.

Counterpart of ``repro/kernels/pallas_compat.py:33 has_tpu``. Entry points
run on the card unless the caller asks for the CPU: ``default_device()``
never picks the CPU on its own.
"""

from __future__ import annotations

import subprocess

import torch


def has_cuda() -> bool:
    return torch.cuda.is_available()


def is_sm90() -> bool:
    """True when card 0 is a Hopper part (compute capability 9.0), the
    target the kernels are compiled for (``sm_90a``)."""
    return has_cuda() and torch.cuda.get_device_capability(0) == (9, 0)


def default_device() -> torch.device:
    """``cuda:0``; raises when there is no CUDA card."""
    if not has_cuda():
        raise RuntimeError(
            "no CUDA card is visible (torch.cuda.is_available() is False); "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return torch.device("cuda:0")


def resolve(device: str | torch.device | None) -> torch.device:
    """``device`` as given, or the card when it is ``None``."""
    return default_device() if device is None else torch.device(device)


def card() -> str:
    """The first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
