"""Device selection for the port's entry points (counterpart of
inferd_tpu/utils/platform.py).

The entry points run on the CUDA device unless the caller asks for the
CPU. A CUDA request on a machine without a usable card is an error, never
a quiet fall back to the CPU: a run that silently measured the CPU would
report its numbers under the card's name.
"""

from __future__ import annotations

import torch

DEVICE_CHOICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """`--device` value -> torch.device; raises if CUDA is asked for and
    absent."""
    if name not in DEVICE_CHOICES:
        raise ValueError(f"--device must be one of {DEVICE_CHOICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda requested but torch finds no CUDA device; "
            "pass --device cpu to run the plain PyTorch path on the host"
        )
    return torch.device(name)


def device_name(device: torch.device) -> str:
    """Human-readable name of the device a run used (the card's name on CUDA)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
