"""Manager: the per-rank fault-tolerance state machine (counterpart of
torchft_tpu/manager.py, narrowed to FT-DDP with kills and single-donor
heals).

Embedded in the train loop, it:

- computes quorums (async, overlapped with the forward pass) through the
  native ManagerServer/Lighthouse plane;
- reconfigures the replica-axis process group when membership changes
  (``configure`` under a fresh store prefix keyed by quorum_id);
- runs fault-tolerant gradient allreduces: non-participating replicas
  contribute zeros, AVG runs as SUM divided by the live participant count,
  and collective errors are swallowed into a sticky per-step error state;
- arbitrates per-step commits through the all-local-rank AND barrier
  (``should_commit``), advancing the step only on quorum-wide success;
- heals: a group the quorum finds behind (a restarted group, or every
  non-primary group at step 0 under ``init_sync=True``) fetches the
  committed state of its assigned donor through the checkpoint transport
  (:class:`~torchft_tpu_torch.checkpointing.HTTPTransport` by default),
  and a donor stages its committed state for it.

Step protocol (see also :class:`torchft_tpu_torch.optim.Optimizer`)::

    manager.start_quorum()          # before forward
    loss.backward()                 # forward/backward
    grads = ft_allreduce_gradients(manager, grads)
    if manager.should_commit():     # commit barrier
        optimizer.step()

Not in the port yet: the pipelined and speculative commit
(``commit_pipeline_depth > 0`` raises), multi-donor striped and delta
heals, the storm rotation, WorldSizeMode, and the history, publishing,
health and goodput planes.
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
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.coordination import ManagerClient, ManagerServer
from torchft_tpu_torch.futures import future_timeout
from torchft_tpu_torch.parallel.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.parallel.store import StoreClient
from torchft_tpu_torch.work import Work, _DummyWork

T = TypeVar("T")

logger = logging.getLogger(__name__)

__all__ = ["Manager", "ExceptionWithTraceback", "HealExhaustedError"]

TIMEOUT_SEC_ENV = "TPUFT_TIMEOUT_SEC"
QUORUM_TIMEOUT_SEC_ENV = "TPUFT_QUORUM_TIMEOUT_SEC"
CONNECT_TIMEOUT_SEC_ENV = "TPUFT_CONNECT_TIMEOUT_SEC"
QUORUM_RETRIES_ENV = "TPUFT_QUORUM_RETRIES"
LIGHTHOUSE_ENV = "TPUFT_LIGHTHOUSE"
MANAGER_PORT_ENV = "TPUFT_MANAGER_PORT"
HEAL_MAX_ATTEMPTS_ENV = "TPUFT_HEAL_MAX_ATTEMPTS"


def _env_timeout(env: str, default: float) -> float:
    value = os.environ.get(env)
    return float(value) if value is not None else default


class HealExhaustedError(RuntimeError):
    """Raised out of the quorum future (``wait_quorum``/``start_quorum``)
    when ``TPUFT_HEAL_MAX_ATTEMPTS`` consecutive heal attempts all failed:
    this replica cannot catch up from any donor it is assigned, so, like a
    quorum timeout or the ``max_retries`` commit RuntimeError, it escalates
    past the step boundary to the supervisor instead of looping on a heal
    that will never land."""


class _DonorRecentlyFailed(Exception):
    """Internal: the assigned donor failed us on the immediately preceding
    attempt; fail this heal round fast (no transfer) so the next quorum
    round can reassign. One-shot per failure: a consecutive assignment of
    the same donor is attempted for real."""


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
            step 0 (the default, as in the reference): those groups heal from
            the primary before their first step.
        commit_pipeline_depth: only 0 (resolve every commit before the next
            dispatch) is ported.
        checkpoint_transport: how heals move state; default an
            :class:`HTTPTransport` with this manager's ``timeout``.
        use_async_quorum: overlap the quorum with the forward pass. A
            healing replica then sits the step out (contributes zeros, the
            max-step cohort participates) and applies the fetched state at
            the commit barrier; with False the heal is applied inside
            ``start_quorum`` and the replica participates at once.
        heal_max_attempts: consecutive failed heal attempts tolerated before
            :class:`HealExhaustedError` escalates out of the quorum future
            (``$TPUFT_HEAL_MAX_ATTEMPTS`` overrides). Each failed attempt
            funnels into :meth:`report_error`: the step does not commit and
            the joiner re-enters the next quorum still joining.
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
        checkpoint_transport: Optional[CheckpointTransport] = None,
        use_async_quorum: bool = True,
        heal_max_attempts: int = 5,
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
        self._use_async_quorum = use_async_quorum
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
        self._checkpoint_transport: CheckpointTransport = (
            checkpoint_transport
            if checkpoint_transport is not None
            else HTTPTransport(timeout=self._timeout)
        )
        self._checkpoint_transport.register_error_callback(self.report_error)

        # The state-dict registry under a readers-writer lock: readers stage
        # a checkpoint for a peer, the writer applies a healed one.
        self._state_dict_lock = RWLock()
        self._load_state_dict_fns: Dict[str, Callable[[Any], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}

        # Heal state: the fetched state dict waits here until the train
        # thread applies it; failed attempts are counted across rounds.
        self._healing = False
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        self._heal_max_attempts = max(
            1, int(os.environ.get(HEAL_MAX_ATTEMPTS_ENV, str(heal_max_attempts)))
        )
        self._heal_attempts = 0
        self._heal_last_failed_donor: Optional[str] = None
        self._heal_failed_donors: Dict[str, bool] = {}

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

    def disallow_state_dict_read(self, timeout: Optional[float] = None) -> None:
        """Takes the state-dict write lock: no checkpoint is staged for a
        peer while the caller mutates registered state."""
        effective = self._timeout if timeout is None else timeout
        if not self._state_dict_lock.w_acquire(effective):
            raise TimeoutError("state dict write lock not acquired")

    def allow_state_dict_read(self) -> None:
        self._state_dict_lock.w_release()

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
        self._checkpoint_transport.shutdown(wait=wait)
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
        the forward pass. With ``use_async_quorum=False`` it waits for the
        quorum and applies a heal before it returns."""
        if self._quorum_future is not None:
            self._quorum_future.result()
        self._errored = None
        self._healing = False
        self._quorum_future = self._executor.submit(
            self._async_quorum,
            shrink_only=shrink_only,
            quorum_timeout=timeout or self._quorum_timeout,
        )
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # The forward pass runs against the recovered state.
                self._apply_pending_state_dict()
                self._healing = False

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
                checkpoint_metadata=self._checkpoint_transport.metadata(),
                shrink_only=shrink_only,
                init_sync=self._init_sync,
                commit_failures=self._commit_failures,
                timeout=quorum_timeout,
            )

        # Async quorum: a healing replica sits this step out and the
        # max-step cohort participates. Sync quorum: the heal is applied
        # before the step, so every member participates.
        if self._use_async_quorum:
            self._participating_replica_rank = quorum.max_rank
            self._participating_replica_world_size = quorum.max_world_size
        else:
            self._participating_replica_rank = quorum.replica_rank
            self._participating_replica_world_size = quorum.replica_world_size
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
                return

        if quorum.recover_dst_replica_ranks:
            # Donor: stage the committed state of this step (the commit
            # pipeline is depth 0, so no uncommitted update exists) until
            # the commit barrier closes the window.
            logger.info(
                "[%s/%d - step %d] peers need recovery from us %s", self._replica_id,
                self._group_rank, self._step, list(quorum.recover_dst_replica_ranks),
            )
            metrics.inc("tpuft_heals_total", role="donor", **self._metric_labels)
            try:
                with metrics.timer("tpuft_heal_send_seconds", **self._metric_labels):
                    self._checkpoint_transport.send_checkpoint(
                        dst_ranks=list(quorum.recover_dst_replica_ranks),
                        step=quorum.max_step,
                        state_dict=self._manager_state_dict(),
                        timeout=self._timeout,
                        quorum_id=quorum.quorum_id,
                    )
            except Exception as e:  # noqa: BLE001
                logger.exception("got exception in donor send: %s", e)
                self.report_error(e)
        if quorum.heal:
            self._heal_as_joiner(quorum)

    def _heal_as_joiner(self, quorum: Any) -> None:
        """One heal attempt from the quorum's assigned donor, with the
        failover accounting around it: the donor's transport address comes
        from its manager, the state from ``recv_checkpoint``. A failed
        attempt funnels into :meth:`report_error` (the step does not commit
        and the joiner re-enters the next quorum still joining; the
        transport keeps the chunks it verified), the donor is skipped once
        if it is assigned again at once, and after ``heal_max_attempts``
        consecutive failures :class:`HealExhaustedError` escalates out of
        the quorum future."""
        self._healing = True
        metrics.set_gauge("tpuft_healing", 1, **self._metric_labels)
        metrics.inc("tpuft_heals_total", role="joiner", **self._metric_labels)
        src_addr = quorum.recover_src_manager_address
        try:
            if self._heal_attempts > 0:
                metrics.inc("tpuft_heal_retries_total", **self._metric_labels)
            if self._heal_failed_donors.get(src_addr, False):
                self._heal_failed_donors[src_addr] = False
                raise _DonorRecentlyFailed(
                    f"donor {src_addr} failed the previous heal attempt; "
                    "skipping one round to let the assignment rotate"
                )
            if self._heal_last_failed_donor is not None and src_addr != self._heal_last_failed_donor:
                metrics.inc("tpuft_heal_donor_failovers_total", **self._metric_labels)
            logger.info(
                "[%s/%d - step %d] healing from %s, max_step=%d", self._replica_id,
                self._group_rank, self._step, src_addr, quorum.max_step,
            )
            donor = ManagerClient(src_addr, connect_timeout=self._connect_timeout)
            try:
                checkpoint_metadata = donor._checkpoint_metadata(
                    self._group_rank, timeout=self._timeout
                )
            finally:
                donor.close()
            if quorum.recover_src_replica_rank is None:
                raise RuntimeError("the quorum assigns a heal without a recovery source rank")
            with metrics.timer("tpuft_heal_recv_seconds", **self._metric_labels):
                self._pending_state_dict = self._checkpoint_transport.recv_checkpoint(
                    src_rank=quorum.recover_src_replica_rank,
                    metadata=checkpoint_metadata,
                    step=quorum.max_step,
                    timeout=self._timeout,
                    quorum_id=quorum.quorum_id,
                )
            # Manager accounting is restored at once; user state is applied
            # from the train thread at the commit barrier.
            self.load_state_dict(self._pending_state_dict["tpuft"])
            self._step = quorum.max_step
            self._heal_attempts = 0
            self._heal_last_failed_donor = None
            self._heal_failed_donors.clear()
        except Exception as e:  # noqa: BLE001
            if not isinstance(e, _DonorRecentlyFailed):
                self._heal_attempts += 1
                self._heal_last_failed_donor = src_addr
                self._heal_failed_donors[src_addr] = True
            logger.exception("got exception in recovery: %s", e)
            self.report_error(e)
            if self._heal_attempts >= self._heal_max_attempts:
                raise HealExhaustedError(
                    f"{self._heal_attempts} consecutive heal attempts failed "
                    f"(last donor {src_addr}); escalating to the supervisor "
                    f"(bound from ${HEAL_MAX_ATTEMPTS_ENV})"
                ) from e

    def _apply_pending_state_dict(self) -> None:
        """Loads the fetched state into every registered state-dict fn,
        under the write lock so no peer is served a half-applied state."""
        if not self._healing:
            raise RuntimeError("no heal in progress")
        self.wait_quorum()
        if self._pending_state_dict is None:
            if self.errored() is None:
                raise RuntimeError("a heal staged no state dict and reported no error")
            return
        if not self._load_state_dict_fns:
            raise RuntimeError("no state dict is registered with the manager")
        pending_user = cast(Dict[str, Any], self._pending_state_dict["user"])
        self.disallow_state_dict_read()
        try:
            with metrics.timer("tpuft_heal_apply_seconds", **self._metric_labels):
                for key, load_fn in self._load_state_dict_fns.items():
                    load_fn(pending_user[key])
        finally:
            self.allow_state_dict_read()
        self._pending_state_dict = None
        metrics.set_gauge("tpuft_healing", 0, **self._metric_labels)

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
        if self._healing:
            self._apply_pending_state_dict()
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
        self._checkpoint_transport.disallow_checkpoint()
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

    def _manager_state_dict(self) -> Dict[str, Any]:
        """What a donor serves: every registered user state and the
        manager's accounting, read under the state-dict read lock."""
        with self._state_dict_lock.r_lock(timeout=self._timeout):
            if not self._user_state_dicts:
                raise RuntimeError("no state dict is registered with the manager")
            return {
                "user": {key: fn() for key, fn in self._user_state_dicts.items()},
                "tpuft": self.state_dict(),
            }

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
        """False for a replica outside the max-step cohort and, with the
        async quorum, for one that is healing this step."""
        if self._participating_replica_rank is None:
            return False
        return not self._healing
