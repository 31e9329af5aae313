"""Device-to-host transfer helpers (counterpart of
torchft_tpu/utils/transfer.py)."""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

__all__ = ["HostCopy", "prefetch_to_host"]


class HostCopy:
    """A host copy of one tensor that may still be in flight.

    For a CUDA tensor the copy goes to pinned host memory without blocking,
    on the current stream, with a CUDA event recorded after it; :meth:`wait`
    blocks on that event only. A CPU tensor is its own host copy."""

    def __init__(self, tensor: torch.Tensor) -> None:
        self._source: Optional[torch.Tensor] = None
        self._event = None
        if tensor.device.type == "cuda":
            self._source = tensor  # kept alive until the copy has landed
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))
        else:
            self._host = tensor

    def wait(self) -> torch.Tensor:
        """The host tensor, once its copy has completed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._source = None
        return self._host


def prefetch_to_host(tensors: Iterable[torch.Tensor]) -> List[HostCopy]:
    """Starts a non-blocking device-to-host copy of every tensor, one CUDA
    event each, so the copies progress together (and overlap whatever the
    caller does next) instead of one blocking round trip per tensor."""
    return [HostCopy(t) for t in tensors]
