"""CheckpointTransport ABC (counterpart of
torchft_tpu/checkpointing/transport.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Generic, List, Optional, Set, TypeVar

T = TypeVar("T")

__all__ = ["CheckpointTransport", "HEAL_PART_PREFIX"]

# Heal-part naming convention: a dict key anywhere in a staged state dict
# that starts with this prefix marks its subtree as an independently
# addressable *part*. A part-aware transport (HTTPTransport) stages each
# part as its own integrity-checked chunk and advertises a part -> chunk
# map in /meta, so a joiner can skip parts it rebuilds more cheaply
# elsewhere. Transports without part support treat the keys as ordinary
# dict keys: the format degrades to a full fetch, never to a wrong one.
HEAL_PART_PREFIX = "heal_part:"


class CheckpointTransport(ABC, Generic[T]):
    """Live peer-to-peer state transfer used for healing joining replicas.

    The donor stages its state and serves it without pausing training; the
    joiner fetches and applies it before its first committed step.

    ``quorum_id`` (optional on both sides) tags the transfer with the
    quorum era it belongs to: transports that can carry it (HTTPTransport)
    fence a joiner from adopting a stale-era donor's state; transports
    that cannot simply ignore it.
    """

    @abstractmethod
    def metadata(self) -> str:
        """Transport metadata handed to peers via the manager (e.g. the
        donor's serving address)."""

    @abstractmethod
    def send_checkpoint(
        self,
        dst_ranks: List[int],
        step: int,
        state_dict: T,
        timeout: float,
        quorum_id: Optional[int] = None,
    ) -> Optional[dict]:
        """Stages/sends ``state_dict`` for ``dst_ranks`` at ``step``.

        May return a JSON-safe staging manifest (step/era/digest/per-chunk
        CRCs; HTTPTransport does); heal callers ignore the return value and
        ``None`` is always a valid answer."""

    @abstractmethod
    def recv_checkpoint(
        self,
        src_rank: int,
        metadata: str,
        step: int,
        timeout: float,
        quorum_id: Optional[int] = None,
        skip_parts: Optional[Set[str]] = None,
        donors: Optional[List[str]] = None,
        local_state: Optional[T] = None,
        stripe_rotation: int = 0,
        donor_info: Optional[dict] = None,
    ) -> T:
        """Fetches the state for ``step`` from ``src_rank``.

        ``skip_parts`` (names of :data:`HEAL_PART_PREFIX` parts the joiner
        rebuilds elsewhere; a part-aware transport returns ``None`` for
        their leaves), ``donors``, ``local_state``, ``stripe_rotation`` and
        ``donor_info`` are the reference's part-skipping, multi-donor
        striping and delta-rejoin hints. Each is an optimization, and a
        transport without that capability MUST ignore it and fetch
        everything from ``metadata`` alone (the port's HTTPTransport does)."""

    def disallow_checkpoint(self) -> None:
        """Stops serving the staged checkpoint (called at commit)."""

    def register_error_callback(self, cb: Callable[[Exception], None]) -> None:
        """Funnel for asynchronous serving-plane failures. The manager
        registers ``report_error`` here; transports without background
        serving machinery have nothing to report and keep this no-op."""

    def shutdown(self, wait: bool = True) -> None:
        """Tears the transport down."""
