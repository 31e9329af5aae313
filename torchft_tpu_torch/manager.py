"""Manager: the per-rank fault-tolerance state machine (counterpart of
torchft_tpu/manager.py, narrowed to what a run of replica groups needs
while no group dies).

Embedded in the train loop, it:

- computes quorums (async, overlapped with the forward pass) through the
  native ManagerServer/Lighthouse plane;
- reconfigures the replica-axis process group when membership changes
  (``configure`` under a fresh store prefix keyed by quorum_id);
- runs fault-tolerant gradient allreduces: non-participating replicas
  contribute zeros, AVG runs as SUM divided by the live participant count,
  and collective errors are swallowed into a sticky per-step error state;
- arbitrates per-step commits through the all-local-rank AND barrier
  (``should_commit``), advancing the step only on quorum-wide success.

Step protocol (see also :class:`torchft_tpu_torch.optim.Optimizer`)::

    manager.start_quorum()          # before forward
    loss.backward()                 # forward/backward
    grads = ft_allreduce_gradients(manager, grads)
    if manager.should_commit():     # commit barrier
        optimizer.step()

Not in this slice, and raising where a run would need them: healing a
joining group from a donor (a quorum that assigns this group a recovery,
including the step-0 sync that ``init_sync=True`` asks of every
non-primary group), the pipelined and speculative commit
(``commit_pipeline_depth > 0``), and the history, publishing, health and
goodput planes.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import socket
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional, TypeVar, cast

import torch

from torchft_tpu_torch import metrics
from torchft_tpu_torch.coordination import ManagerClient, ManagerServer
from torchft_tpu_torch.futures import future_timeout
from torchft_tpu_torch.parallel.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.parallel.store import StoreClient
from torchft_tpu_torch.work import Work, _DummyWork

T = TypeVar("T")

logger = logging.getLogger(__name__)

__all__ = ["Manager", "ExceptionWithTraceback"]

TIMEOUT_SEC_ENV = "TPUFT_TIMEOUT_SEC"
QUORUM_TIMEOUT_SEC_ENV = "TPUFT_QUORUM_TIMEOUT_SEC"
CONNECT_TIMEOUT_SEC_ENV = "TPUFT_CONNECT_TIMEOUT_SEC"
QUORUM_RETRIES_ENV = "TPUFT_QUORUM_RETRIES"
LIGHTHOUSE_ENV = "TPUFT_LIGHTHOUSE"
MANAGER_PORT_ENV = "TPUFT_MANAGER_PORT"

_NEXT_SLICE = (
    "healing is ported in the next slice of torchft_tpu_torch (ROADMAP.md, "
    "\"Slices, in order\")"
)


def _env_timeout(env: str, default: float) -> float:
    value = os.environ.get(env)
    return float(value) if value is not None else default


class ExceptionWithTraceback(Exception):
    """Carries a worker-thread exception across the report_error funnel with
    its formatted stack attached."""

    def __init__(self, e: Exception) -> None:
        tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
        super().__init__(f"{e}\n{tb}")
        self.original_exception = e
        self.stack_trace: str = tb


class Manager:
    """Fault tolerance manager for one rank of one replica group.

    Args:
        pg: the replica-axis process group (reconfigured on quorum change).
        min_replica_size: minimum replicas for a step to commit.
        store: rendezvous store client for this replica group.
        store_addr: the group store's "host:port" advertised to other groups.
        replica_id: stable prefix for this group's identity; a uuid suffix is
            appended per process lifetime.
        group_rank/group_world_size: this process's coordinates inside the
            replica group.
        init_sync: ask the quorum to sync every non-primary group's state at
            step 0 (the default, as in the reference). Such a sync is a heal,
            which this slice does not run: groups that start from the same
            seed pass ``init_sync=False``.
        commit_pipeline_depth: only 0 (resolve every commit before the next
            dispatch) is ported.
    """

    def __init__(
        self,
        pg: ProcessGroup,
        min_replica_size: int,
        store: StoreClient,
        store_addr: str,
        timeout: float = 60.0,
        quorum_timeout: float = 60.0,
        connect_timeout: float = 10.0,
        group_rank: Optional[int] = None,
        group_world_size: Optional[int] = None,
        lighthouse_addr: Optional[str] = None,
        replica_id: Optional[str] = None,
        manager_bind: str = "[::]:0",
        hostname: str = "",
        heartbeat_interval: float = 0.1,
        init_sync: bool = True,
        max_retries: Optional[int] = None,
        quorum_retries: int = 0,
        commit_pipeline_depth: int = 0,
    ) -> None:
        if commit_pipeline_depth:
            raise NotImplementedError(
                "commit_pipeline_depth > 0 (the pipelined commit) is ported in a "
                "later slice of torchft_tpu_torch"
            )
        self._pg = pg
        self._min_replica_size = min_replica_size
        self._timeout = _env_timeout(TIMEOUT_SEC_ENV, timeout)
        self._quorum_timeout = _env_timeout(QUORUM_TIMEOUT_SEC_ENV, quorum_timeout)
        self._connect_timeout = _env_timeout(CONNECT_TIMEOUT_SEC_ENV, connect_timeout)
        self._quorum_retries = int(os.environ.get(QUORUM_RETRIES_ENV, str(quorum_retries)))
        self._init_sync = init_sync
        self._max_retries = max_retries
        self._group_rank: int = (
            group_rank if group_rank is not None else int(os.environ.get("GROUP_RANK", "0"))
        )
        self._group_world_size: int = (
            group_world_size
            if group_world_size is not None
            else int(os.environ.get("GROUP_WORLD_SIZE", "1"))
        )
        self._store = store

        self._load_state_dict_fns: Dict[str, Callable[[Any], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}

        # Step/commit accounting.
        self._step = 0
        self._batches_committed = 0
        self._commit_failures = 0

        self._errored: Optional[ExceptionWithTraceback] = None
        self._shutdown_hooks: List[Callable[[], None]] = []

        # Quorum state.
        self._quorum_id = -1
        self._quorum_future: Optional[concurrent.futures.Future] = None
        self._participating_replica_rank: Optional[int] = None
        self._participating_replica_world_size: int = 0
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tpuft_quorum"
        )

        # Rank 0 embeds the native ManagerServer; other local ranks discover
        # its address through the group store.
        self._manager: Optional[ManagerServer] = None
        hostname = hostname or socket.gethostname()
        if self._group_rank == 0:
            lighthouse = lighthouse_addr or os.environ.get(LIGHTHOUSE_ENV)
            if lighthouse is None:
                raise ValueError(f"rank 0 requires lighthouse_addr or ${LIGHTHOUSE_ENV}")
            bind = manager_bind
            port_env = os.environ.get(MANAGER_PORT_ENV)
            if port_env is not None and bind == "[::]:0":
                bind = f"[::]:{port_env}"
            replica_id = (replica_id or "") + ":" + str(uuid.uuid4())
            self._manager = ManagerServer(
                replica_id=replica_id,
                lighthouse_addr=lighthouse,
                address=hostname,
                bind=bind,
                store_addr=store_addr,
                world_size=self._group_world_size,
                heartbeat_interval=heartbeat_interval,
                connect_timeout=self._connect_timeout,
                quorum_retries=self._quorum_retries,
            )
            self._store.set("manager_addr", self._manager.address().encode())
            self._store.set("replica_id", replica_id.encode())

        addr = self._store.get("manager_addr", timeout=self._connect_timeout)
        replica_id_bytes = self._store.get("replica_id", timeout=self._connect_timeout)
        if addr is None or replica_id_bytes is None:
            raise RuntimeError("the group store holds no manager address")
        self._replica_id = replica_id_bytes.decode()
        self._client = ManagerClient(addr.decode(), connect_timeout=self._connect_timeout)
        self._metric_labels = {
            "replica_id": self._replica_id.split(":", 1)[0] or "replica",
            "group_rank": str(self._group_rank),
        }

    # ------------------------------------------------------------------
    # state dict registry
    # ------------------------------------------------------------------

    def register_state_dict_fn(
        self,
        key: str,
        load_state_dict: Callable[[T], None],
        state_dict: Callable[[], T],
    ) -> None:
        if key in self._load_state_dict_fns:
            raise ValueError(f"duplicate state dict key {key}")
        self._load_state_dict_fns[key] = cast(Callable[[Any], None], load_state_dict)
        self._user_state_dicts[key] = state_dict

    @property
    def commit_pipeline_depth(self) -> int:
        return 0

    def register_shutdown_hook(self, hook: Callable[[], None]) -> None:
        """Runs ``hook`` during :meth:`shutdown` (before the executor stops),
        so per-manager resources (ddp's wire worker) follow the manager's
        lifecycle. Hooks run at most once; their errors are swallowed."""
        self._shutdown_hooks.append(hook)

    def shutdown(self, wait: bool = True) -> None:
        hooks, self._shutdown_hooks = self._shutdown_hooks, []
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — one hook must not block teardown
                logger.exception("shutdown hook failed (ignored)")
        if self._manager is not None:
            self._manager.shutdown()
        self._executor.shutdown(wait=wait)
        self._client.close()

    # ------------------------------------------------------------------
    # allreduce
    # ------------------------------------------------------------------

    def allreduce(
        self,
        tensor: torch.Tensor,
        should_quantize: bool = False,
        reduce_op: ReduceOp = ReduceOp.AVG,
    ) -> Work:
        """Fault-tolerant allreduce of a CPU tensor across the participating
        replica groups; resolves to the result. On error the work resolves
        to the input and the step is poisoned (it will not commit). AVG runs
        as SUM + divide by ``num_participants()``; non-participating
        replicas contribute zeros."""
        if self.errored():
            return _DummyWork(tensor)
        self.wait_quorum()
        num_participants = self.num_participants()
        if not self.is_participating():
            tensor = torch.zeros_like(tensor)
        pg_reduce_op = reduce_op
        if reduce_op == ReduceOp.AVG:
            if not tensor.dtype.is_floating_point:
                raise ValueError("average reduce op requires floating point tensors")
            pg_reduce_op = ReduceOp.SUM
        try:
            if should_quantize:
                from torchft_tpu_torch.parallel.collectives import allreduce_quantized

                work = allreduce_quantized([tensor], pg_reduce_op, self._pg)
            else:
                work = self._pg.allreduce([tensor], pg_reduce_op)

            def callback(result: List[torch.Tensor]) -> torch.Tensor:
                out = result[0]
                if reduce_op == ReduceOp.AVG:
                    out = (out / num_participants).to(out.dtype)
                return out

            return self.wrap_work(work.then(callback), default=tensor)
        except Exception as e:  # noqa: BLE001
            logger.exception("allreduce failed; poisoning this step: %s", e)
            self.report_error(e)
            return _DummyWork(tensor)

    def allreduce_prequantized(self, payload: torch.Tensor, scales: torch.Tensor) -> Work:
        """Averages device-quantized data (payload + f32 block scales,
        ops/quantization.py layout) across participating replicas:
        non-participants zero their contribution by zeroing scales, errors
        resolve the work to None and poison the step. Resolves to (payload,
        scales) of the average, on the host, for dequantization on the
        device."""
        from torchft_tpu_torch.parallel.collectives import allreduce_quantized_wire

        if self.errored():
            return _DummyWork(None)
        self.wait_quorum()
        num_participants = self.num_participants()
        if self.is_lone_replica():
            # Averaging over one participant is the identity: the payload
            # stays where it is and goes straight back to the dequantizer.
            return self.wrap_work(_DummyWork((payload, scales)), default=None)
        if not self.is_participating():
            scales = scales * 0
        try:
            work = allreduce_quantized_wire(payload, scales, ReduceOp.SUM, self._pg)
            return self.wrap_work(
                work.then(lambda ps: (ps[0], ps[1] / max(num_participants, 1))),
                default=None,
            )
        except Exception as e:  # noqa: BLE001
            logger.exception("allreduce failed; poisoning this step: %s", e)
            self.report_error(e)
            return _DummyWork(None)

    # ------------------------------------------------------------------
    # error tracking
    # ------------------------------------------------------------------

    def report_error(self, e: Exception) -> None:
        """Records an error for this step: the step will not commit and the
        comm layer is reconfigured on the next quorum."""
        self._errored = ExceptionWithTraceback(e)
        metrics.inc("tpuft_errors_total", **self._metric_labels)

    def errored(self) -> Optional[ExceptionWithTraceback]:
        return self._errored

    def wrap_work(self, work: Work, default: Any, timeout: Optional[float] = None) -> Work:
        """Bounds ``work`` with a deadline and swallows its errors into
        :meth:`report_error`, resolving to ``default`` instead."""
        timed = Work(future_timeout(work._future, timeout or self._timeout))

        def handler(e: Exception) -> None:
            logger.exception("future raised; remaining callbacks skipped: %s", e)
            self.report_error(e)

        return timed.with_error_handler(handler, default)

    # ------------------------------------------------------------------
    # quorum
    # ------------------------------------------------------------------

    def start_quorum(self, shrink_only: bool = False, timeout: Optional[float] = None) -> None:
        """Starts the quorum on the manager's executor, so it overlaps the
        caller's work, and readies the manager for a new step. Call before
        the forward pass."""
        if self._quorum_future is not None:
            self._quorum_future.result()
        self._errored = None
        self._quorum_future = self._executor.submit(
            self._async_quorum,
            shrink_only=shrink_only,
            quorum_timeout=timeout or self._quorum_timeout,
        )

    def wait_quorum(self) -> None:
        """Blocks until the quorum completes; the process group is healthy
        after."""
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum before wait_quorum")
        self._quorum_future.result()

    def _async_quorum(self, shrink_only: bool, quorum_timeout: float) -> None:
        with metrics.timer("tpuft_quorum_seconds", **self._metric_labels):
            quorum = self._client._quorum(
                group_rank=self._group_rank,
                step=self._step,
                checkpoint_metadata="",
                shrink_only=shrink_only,
                init_sync=self._init_sync,
                commit_failures=self._commit_failures,
                timeout=quorum_timeout,
            )
        if quorum.heal or quorum.recover_dst_replica_ranks:
            role = "heal from a donor" if quorum.heal else (
                f"serve a checkpoint to replica ranks {list(quorum.recover_dst_replica_ranks)}"
            )
            raise NotImplementedError(
                f"quorum {quorum.quorum_id} asks this group to {role} (step "
                f"{self._step}, max step {quorum.max_step}); {_NEXT_SLICE}. Groups "
                "that start from the same seed pass init_sync=False."
            )

        # The max-step cohort participates (with no heal, every member).
        self._participating_replica_rank = quorum.max_rank
        self._participating_replica_world_size = quorum.max_world_size
        metrics.set_gauge(
            "tpuft_participants", self._participating_replica_world_size, **self._metric_labels
        )

        if quorum.quorum_id != self._quorum_id:
            metrics.inc("tpuft_quorum_changes_total", **self._metric_labels)
            store_prefixed_addr = (
                f"{quorum.store_address}/tpuft/{quorum.quorum_id}/{self._group_rank}"
            )
            logger.info(
                "[%s/%d] reconfiguring for quorum_id=%d %s", self._replica_id,
                self._group_rank, quorum.quorum_id, store_prefixed_addr,
            )
            try:
                with metrics.timer("tpuft_pg_configure_seconds", **self._metric_labels):
                    self._pg.configure(
                        store_prefixed_addr, self._replica_id, quorum.replica_rank,
                        quorum.replica_world_size,
                    )
                self._quorum_id = quorum.quorum_id
            except Exception as e:  # noqa: BLE001
                logger.exception("got exception in pg configure: %s", e)
                self.report_error(e)

    # ------------------------------------------------------------------
    # commit
    # ------------------------------------------------------------------

    def should_commit_async(
        self, timeout: Optional[float] = None
    ) -> "concurrent.futures.Future[bool]":
        """:meth:`should_commit` on the manager's executor, so the barrier
        RPC overlaps the device work the caller still waits for."""
        return self._executor.submit(self.should_commit, timeout)

    def should_commit(self, timeout: Optional[float] = None) -> bool:
        """All-local-rank commit barrier. Call after the step's math is
        complete and step the optimizer only when this returns True."""
        if err := self._pg.errored():
            self.report_error(err)
        enough_replicas = self.num_participants() >= self._min_replica_size
        local_should_commit = enough_replicas and self._errored is None
        with metrics.timer("tpuft_commit_barrier_seconds", **self._metric_labels):
            should_commit = self._client.should_commit(
                self._group_rank, self._step, local_should_commit,
                timeout=timeout or self._timeout,
            )
        logger.info(
            "[%s/%d - step %d] should_commit=%s enough_replicas=%s, errored=%s",
            self._replica_id, self._group_rank, self._step, should_commit,
            enough_replicas, self._errored,
        )
        if should_commit:
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
            metrics.inc("tpuft_commits_total", **self._metric_labels)
        else:
            self._commit_failures += 1
            metrics.inc("tpuft_commit_failures_total", **self._metric_labels)
            if self._max_retries is not None and self._commit_failures > self._max_retries:
                raise RuntimeError(
                    f"should_commit failed {self._commit_failures} times consecutively, "
                    f"exceeding max_retries={self._max_retries}"
                )
        return should_commit

    # ------------------------------------------------------------------
    # state dict / accounting
    # ------------------------------------------------------------------

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def state_dict(self) -> Dict[str, int]:
        """Manager accounting for user checkpoints: persist alongside model
        state and restore via :meth:`load_state_dict`."""
        return {"step": self._step, "batches_committed": self._batches_committed}

    def current_step(self) -> int:
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    def participating_rank(self) -> Optional[int]:
        if self._quorum_future is None:
            return None
        self.wait_quorum()
        return self._participating_replica_rank

    def num_participants(self) -> int:
        if self._quorum_future is None:
            return 0
        self.wait_quorum()
        return self._participating_replica_world_size

    def is_lone_replica(self) -> bool:
        """True when this replica is alone on the wire for the current
        quorum: sole participant and a process group of one. Then every
        averaging collective is an exact identity."""
        return (
            self.num_participants() == 1
            and self.is_participating()
            and self._pg.size() <= 1
        )

    def is_participating(self) -> bool:
        return self._participating_replica_rank is not None
