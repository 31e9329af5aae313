"""Fault-tolerant data parallelism over the replica axis (counterpart of
torchft_tpu/ddp.py).

Upstream torchft's ``DistributedDataParallel`` hooks torch's backward to
route gradient buckets through ``manager.allreduce``. Here, as in the JAX
package, the sync is an explicit step between backward and the optimizer:

- :func:`ft_allreduce_gradients` averages a list of gradient tensors across
  the replica groups in buckets of at most ``TPUFT_BUCKET_MB`` (16 MiB by
  default), planned greedily per dtype in the list's order, which is the
  same on every replica for identical models;
- :class:`DistributedDataParallel` carries (module, manager) and syncs the
  module's ``.grad`` tensors in place.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
import weakref
from typing import Any, List, Sequence

import torch

from torchft_tpu_torch import metrics
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.ops.quantization import default_wire, make_tree_fp8_codec
from torchft_tpu_torch.utils.transfer import prefetch_to_host

__all__ = ["ft_allreduce_gradients", "DistributedDataParallel", "BUCKET_BYTES_ENV"]

BUCKET_BYTES_ENV = "TPUFT_BUCKET_MB"
_DEFAULT_BUCKET_BYTES = 16 * 1024 * 1024

# One FIFO wire worker per Manager (see _wire_worker_for).
_WIRE_WORKERS: "weakref.WeakKeyDictionary[Manager, Any]" = weakref.WeakKeyDictionary()
_WIRE_WORKERS_LOCK = threading.Lock()


def _bucket_cap_bytes() -> int:
    return int(float(os.environ.get(BUCKET_BYTES_ENV, "0")) * 1024 * 1024) or (
        _DEFAULT_BUCKET_BYTES
    )


def _plan_buckets(leaves: Sequence[torch.Tensor], cap_bytes: int) -> List[List[int]]:
    """Greedy same-dtype buckets of at most ``cap_bytes`` each, in list
    order (deterministic across replicas: DDP's frozen-bucket invariant)."""
    buckets: List[List[int]] = []
    open_bucket: dict = {}  # dtype -> (bucket index, bytes so far)
    for index, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        slot = open_bucket.get(leaf.dtype)
        if slot is not None and slot[1] + nbytes <= cap_bytes:
            buckets[slot[0]].append(index)
            open_bucket[leaf.dtype] = (slot[0], slot[1] + nbytes)
        else:
            buckets.append([index])
            open_bucket[leaf.dtype] = (len(buckets) - 1, nbytes)
    return buckets


def _single_participant_identity(manager: Manager) -> bool:
    """True when the allreduce would be an exact identity (see
    Manager.is_lone_replica): then the sync skips the wire entirely."""
    if manager.errored() is not None:
        return False
    manager.wait_quorum()
    return manager.is_lone_replica()


def ft_allreduce_gradients(
    manager: Manager, grads: Sequence[torch.Tensor], should_quantize: bool = False
) -> List[torch.Tensor]:
    """Averages gradient tensors across replica groups; returns tensors on
    the inputs' devices. On error the step is poisoned (its commit will
    fail) and the local gradients come back, so callers never branch.

    Every bucket's device-to-host copy starts up front; each bucket then
    goes on the wire as its copy lands and comes back to the device as its
    average arrives. With ``should_quantize`` the buckets are quantized on
    the device (kernel B1), only payload and block scales cross to the
    host, and the average is dequantized on the device (kernel B2)."""
    grads = list(grads)
    for grad in grads:
        if not grad.dtype.is_floating_point:
            raise TypeError(f"gradient sync averages float tensors, got {grad.dtype}")
    if _single_participant_identity(manager):
        return grads
    if should_quantize:
        return _ft_allreduce_gradients_fp8(manager, grads)

    buckets = _plan_buckets(grads, _bucket_cap_bytes())
    flats = [torch.cat([grads[i].reshape(-1) for i in members]) for members in buckets]
    copies = prefetch_to_host(flats)
    works = []
    for flat, copy in zip(flats, copies):
        metrics.inc("tpuft_wire_bytes_total", flat.numel() * flat.element_size(), path="bucket")
        works.append(manager.allreduce(copy.wait()))
    out: List[Any] = [None] * len(grads)
    for bucket_index, (members, work) in enumerate(zip(buckets, works)):
        wire_t0 = time.perf_counter()
        averaged = work.wait()
        metrics.observe("tpuft_wire_bucket_seconds", time.perf_counter() - wire_t0, path="bucket")
        offset = 0
        for i in members:
            size = grads[i].numel()
            out[i] = averaged[offset : offset + size].reshape(grads[i].shape).to(grads[i].device)
            offset += size
    return out


def _wire_worker_for(manager: Manager) -> concurrent.futures.ThreadPoolExecutor:
    """The single FIFO wire worker of one Manager (= one replica group).

    One worker per group, not per process: replica groups that run as
    threads of one process would otherwise serialize one group's exchange
    behind another's while neither can finish alone. Torn down by
    Manager.shutdown, with a GC finalizer as the backstop."""
    with _WIRE_WORKERS_LOCK:
        worker = _WIRE_WORKERS.get(manager)
        if worker is None:
            worker = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tpuft-fp8-order"
            )
            _WIRE_WORKERS[manager] = worker
            manager.register_shutdown_hook(lambda w=worker: w.shutdown(wait=False))
            weakref.finalize(manager, worker.shutdown, wait=False)
        return worker


def _ft_allreduce_gradients_fp8(
    manager: Manager, grads: List[torch.Tensor]
) -> List[torch.Tensor]:
    """Quantized sync, bucketed: every bucket is quantized on the device and
    its async device-to-host copy started up front; the wire exchanges then
    run strictly in bucket order, one at a time, on the group's single FIFO
    worker, while this thread dequantizes the buckets already averaged.

    The exchanges must not overlap: the process group's collectives are
    order-matched byte streams with no op tags, so concurrent buckets could
    enqueue their ops in different orders on different replicas. No wire op
    may outlive the step either: on a failed bucket the queued exchanges are
    cancelled and the in-flight one drained before returning."""
    wire = default_wire()  # read once: the env can change between calls
    buckets = _plan_buckets(grads, _bucket_cap_bytes())
    quantized = []
    for members in buckets:
        quantize, dequantize = make_tree_fp8_codec([grads[i] for i in members], wire=wire)
        payload, scales = quantize([grads[i] for i in members])
        quantized.append((members, dequantize, prefetch_to_host((payload, scales))))

    out: List[Any] = [None] * len(grads)
    device = grads[0].device
    wire_worker = _wire_worker_for(manager)
    futures: List[concurrent.futures.Future] = []
    try:
        # Submit inside the try: a submit that raises mid-loop (a concurrent
        # shutdown closed the executor) still reaches the cancel-and-drain.
        for _, _, copies in quantized:
            futures.append(
                wire_worker.submit(
                    lambda c=copies: manager.allreduce_prequantized(
                        c[0].wait(), c[1].wait()
                    ).wait()
                )
            )
        for (members, dequantize, _), future in zip(quantized, futures):
            wire_t0 = time.perf_counter()
            result = future.result()
            metrics.observe("tpuft_wire_bucket_seconds", time.perf_counter() - wire_t0, path="fp8")
            if result is None:
                # The allreduce failed (error reported; the step will not
                # commit): hand back the local gradients.
                return grads
            avg_payload, avg_scales = result
            averaged = dequantize(avg_payload.to(device), avg_scales.to(device))
            for slot, i in enumerate(members):
                out[i] = averaged[slot]
    finally:
        # Success: every future is done and these are no-ops. Failure:
        # cancel the queued exchanges and drain the in-flight one (its
        # collective carries its own timeout), so the worker is idle at the
        # step boundary.
        for f in futures:
            f.cancel()
        concurrent.futures.wait(futures)
    return out


class DistributedDataParallel:
    """Carries (module, manager); calling it runs the module. The gradient
    path is :meth:`sync_gradients`, which averages the module's ``.grad``
    tensors in place."""

    def __init__(self, manager: Manager, module: torch.nn.Module) -> None:
        self._manager = manager
        self._module = module

    @property
    def module(self) -> torch.nn.Module:
        return self._module

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._module(*args, **kwargs)

    def sync_gradients(self, should_quantize: bool = False) -> None:
        params = [p for p in self._module.parameters() if p.grad is not None]
        averaged = ft_allreduce_gradients(
            self._manager, [p.grad for p in params], should_quantize
        )
        for param, grad in zip(params, averaged):
            param.grad = grad
