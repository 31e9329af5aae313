"""Resizable process groups over host networking (counterpart of
torchft_tpu/parallel/process_group.py).

Fault tolerance is built on reconfigurable collective groups (upstream
torchft process_group.py:133-389): ``configure()`` tears the group down and
re-rendezvouses under a fresh store prefix, ``abort()`` cancels outstanding
work, ``errored()`` reports a sticky failure. The group spans the same
local rank of every replica group; its collectives take torch CPU tensors
(the wire stages device tensors to host first) and return a :class:`Work`.

This slice ports the interface, the loopback :class:`ProcessGroupDummy` and
the wrappers the Manager uses; the collective backend is
:class:`~torchft_tpu_torch.parallel.native_pg.ProcessGroupNative`. The
Python TCP backend (``ProcessGroupTCP``), reduce_scatter and point-to-point
sends come with later slices.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence

import torch

from torchft_tpu_torch.work import Work, _DummyWork

logger = logging.getLogger(__name__)

__all__ = [
    "ReduceOp",
    "ProcessGroup",
    "ProcessGroupDummy",
    "ErrorSwallowingProcessGroupWrapper",
    "ManagedProcessGroup",
]


class ReduceOp(Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


def _copies(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [t.clone() for t in tensors]


class ProcessGroup(ABC):
    """Resizable collective group. All collectives are asynchronous: they
    return a :class:`Work` whose ``wait()`` yields the result tensors.
    ``configure`` must be idempotent and safe to call while ops are
    outstanding (outstanding work fails, the new epoch starts clean)."""

    def __init__(self) -> None:
        self._timeout: float = 60.0

    @abstractmethod
    def configure(
        self, store_addr: str, replica_id: str, rank: int, world_size: int
    ) -> None:
        """(Re)initializes the group: ``store_addr`` is "host:port/prefix",
        fresh per quorum; rank/world_size are the replica-axis coordinates."""

    @abstractmethod
    def abort(self) -> None:
        """Cancels outstanding collectives and poisons the group until the
        next configure()."""

    @abstractmethod
    def shutdown(self) -> None:
        """Permanently tears the group down."""

    @abstractmethod
    def errored(self) -> Optional[Exception]:
        """Sticky error state since last configure (None when healthy)."""

    def set_timeout(self, timeout: float) -> None:
        self._timeout = timeout

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def rank(self) -> int: ...

    def getBackendName(self) -> str:
        return type(self).__name__

    @abstractmethod
    def allreduce(self, tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM) -> Work:
        """Elementwise reduction of each tensor across ranks; result on all."""

    @abstractmethod
    def allgather(self, tensors: Sequence[torch.Tensor]) -> Work:
        """Result: list over ranks of the rank's tensor list."""

    @abstractmethod
    def broadcast(self, tensors: Sequence[torch.Tensor], root: int = 0) -> Work:
        """Root's tensors distributed to all ranks."""

    @abstractmethod
    def alltoall(self, tensors: Sequence[torch.Tensor]) -> Work:
        """tensors[i] goes to rank i; result[i] came from rank i."""

    @abstractmethod
    def barrier(self) -> Work: ...


class ProcessGroupDummy(ProcessGroup):
    """World-size-1 loopback: copies inputs to outputs, counts calls."""

    def __init__(self, rank: int = 0, world: int = 1) -> None:
        super().__init__()
        if rank != 0 or world != 1:
            raise ValueError("ProcessGroupDummy is a group of one")
        self.configure_count = 0
        self.op_counts: Dict[str, int] = {}

    def _count(self, name: str) -> None:
        self.op_counts[name] = self.op_counts.get(name, 0) + 1

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        self.configure_count += 1

    def abort(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def errored(self) -> Optional[Exception]:
        return None

    def size(self) -> int:
        return 1

    def rank(self) -> int:
        return 0

    def allreduce(self, tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM) -> Work:
        self._count("allreduce")
        return _DummyWork(_copies(tensors))

    def allgather(self, tensors: Sequence[torch.Tensor]) -> Work:
        self._count("allgather")
        return _DummyWork([_copies(tensors)])

    def broadcast(self, tensors: Sequence[torch.Tensor], root: int = 0) -> Work:
        self._count("broadcast")
        return _DummyWork(_copies(tensors))

    def alltoall(self, tensors: Sequence[torch.Tensor]) -> Work:
        self._count("alltoall")
        return _DummyWork(_copies(tensors))

    def barrier(self) -> Work:
        self._count("barrier")
        return _DummyWork(None)


class _WrapperBase(ProcessGroup):
    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__()
        self._pg = pg

    @property
    def parent(self) -> ProcessGroup:
        return self._pg

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        self._pg.configure(store_addr, replica_id, rank, world_size)

    def abort(self) -> None:
        self._pg.abort()

    def shutdown(self) -> None:
        self._pg.shutdown()

    def errored(self) -> Optional[Exception]:
        return self._pg.errored()

    def set_timeout(self, timeout: float) -> None:
        self._pg.set_timeout(timeout)

    def size(self) -> int:
        return self._pg.size()

    def rank(self) -> int:
        return self._pg.rank()

    def allreduce(self, tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._pg.allreduce(tensors, op)

    def allgather(self, tensors: Sequence[torch.Tensor]) -> Work:
        return self._pg.allgather(tensors)

    def broadcast(self, tensors: Sequence[torch.Tensor], root: int = 0) -> Work:
        return self._pg.broadcast(tensors, root)

    def alltoall(self, tensors: Sequence[torch.Tensor]) -> Work:
        return self._pg.alltoall(tensors)

    def barrier(self) -> Work:
        return self._pg.barrier()


class ErrorSwallowingProcessGroupWrapper(_WrapperBase):
    """Converts collective exceptions into a recorded error + dummy work;
    everything after the first error is skipped until reconfigure (upstream
    torchft process_group.py:1084-1179). Lets the train loop keep stepping
    while the manager arranges reconfiguration."""

    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__(pg)
        self._error: Optional[Exception] = None

    def errored(self) -> Optional[Exception]:
        return self._error or self._pg.errored()

    def report_error(self, e: Exception) -> None:
        self._error = e

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        self._error = None
        super().configure(store_addr, replica_id, rank, world_size)

    def _guard(self, fn: Callable[[], Work], fallback: object) -> Work:
        if self.errored() is not None:
            return _DummyWork(fallback)
        try:
            work = fn()
        except Exception as e:  # noqa: BLE001
            self.report_error(e)
            return _DummyWork(fallback)
        return work.with_error_handler(self.report_error, fallback)

    def allreduce(self, tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._guard(lambda: self._pg.allreduce(tensors, op), _copies(tensors))

    def broadcast(self, tensors: Sequence[torch.Tensor], root: int = 0) -> Work:
        return self._guard(lambda: self._pg.broadcast(tensors, root), _copies(tensors))


class ManagedProcessGroup(_WrapperBase):
    """Routes allreduce through the Manager so it picks up quorum/error
    semantics; size() reports the live participant count (upstream torchft
    process_group.py:1233-1266)."""

    def __init__(self, manager: "Manager") -> None:  # noqa: F821
        super().__init__(manager._pg)
        self._manager = manager

    def allreduce(self, tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.AVG) -> Work:
        # Only SUM/AVG have world-size-independent manager semantics (SUM +
        # divide-by-participants); MAX/MIN would silently change meaning when
        # non-participants contribute zeros, so reject them loudly.
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise ValueError(
                f"ManagedProcessGroup.allreduce supports SUM/AVG only, got {op}"
            )
        return Work.gather(
            [self._manager.allreduce(tensor, reduce_op=op) for tensor in tensors]
        )

    def size(self) -> int:
        return self._manager.num_participants()

    def getBackendName(self) -> str:
        return "tpuft-managed"
