"""Device selection (counterpart of torchft_tpu/utils/platform.py).

Entry points default to the CUDA card and never fall back to the CPU on
their own: a caller who wants the CPU passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device", "is_hopper"]

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA card; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return default_device()  # raises with the same message
    return device


def is_hopper(device: Optional[DeviceLike] = None) -> bool:
    """True when ``device`` (default: the current card) is an sm_90 part,
    the only target the kernels in ``csrc/`` are built for."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)
