"""Checkpoint transports: live peer-to-peer healing of state trees
(counterpart of torchft_tpu/checkpointing/__init__.py, with the same
names).

The port carries the single-donor HTTP heal (:class:`HTTPTransport`). The
reference's other transports and knobs are named here so that code written
against the reference finds them, and each says what it does in the port:
``PGTransport`` and ``ServeChild`` raise ``NotImplementedError`` (ROADMAP
queue A11), and the striping and delta switches read off, since the port's
transport fetches every chunk from the assigned donor (ROADMAP queue A6).
"""

from __future__ import annotations

from typing import Any

from torchft_tpu_torch.checkpointing.http_transport import (
    HealChecksumError,
    HealEraMismatch,
    HealIntegrityError,
    HealStalledError,
    HTTPTransport,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

__all__ = [
    "CheckpointTransport",
    "HTTPTransport",
    "PGTransport",
    "HealChecksumError",
    "HealEraMismatch",
    "HealIntegrityError",
    "HealStalledError",
    "ServeChild",
    "ServeChildCrashed",
    "ServeChildUnavailable",
    "heal_delta_enabled",
    "heal_stripe_enabled",
    "heal_stripe_max_donors",
]

_SIDECARS = "is not ported to torchft_tpu_torch yet (ROADMAP.md, queue A11)"


class PGTransport:
    """The reference's checkpoint transport over a process group."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"PGTransport {_SIDECARS}")


class ServeChild:
    """The reference's heal-serving child process."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"ServeChild {_SIDECARS}")


class ServeChildUnavailable(RuntimeError):
    """No live serving child (the reference's error; never raised here)."""


class ServeChildCrashed(ServeChildUnavailable):
    """The serving child died (the reference's error; never raised here)."""


def heal_stripe_enabled() -> bool:
    """Whether heals stripe across donors: never in the port."""
    return False


def heal_stripe_max_donors(default: int = 8) -> int:
    """Donors one heal fetches from: the assigned one, in the port."""
    return 1


def heal_delta_enabled() -> bool:
    """Whether a rejoiner adopts unchanged chunks of its own state: never
    in the port."""
    return False
