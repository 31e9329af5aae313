"""ProcessGroupNative: the C++ collective engine behind the process-group
interface (counterpart of torchft_tpu/parallel/native_pg.py).

Ring allreduce, ring allgather, linear broadcast and pairwise alltoall run
in C++ (native/src/collectives.cc) over a full TCP mesh, with torch CPU
tensors passed by pointer through ctypes. Calls release the GIL, so
collectives overlap Python-side training. ``configure`` rendezvouses under
a fresh store prefix per quorum, ``errored()`` is sticky, ``abort`` closes
the mesh and fails in-flight ops. Every rank's results are bitwise
identical.
"""

from __future__ import annotations

import ctypes
import logging
import queue
import struct
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from torchft_tpu_torch import _native
from torchft_tpu_torch.parallel.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.work import Work

logger = logging.getLogger(__name__)

__all__ = ["ProcessGroupNative"]

# native/src/collectives.h DType; bf16 reduces in f32.
_DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int32: 2,
    torch.int64: 3,
    torch.uint8: 4,
    torch.bfloat16: 5,
}

_REDUCE_CODES = {
    ReduceOp.SUM: 0,
    ReduceOp.AVG: 1,
    ReduceOp.MAX: 2,
    ReduceOp.MIN: 3,
}


def _dtype_code(dtype: torch.dtype) -> int:
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"unsupported dtype for native collectives: {dtype}")
    return code


def _host(tensor) -> torch.Tensor:
    """A contiguous CPU tensor (numpy arrays are taken without a copy)."""
    if isinstance(tensor, np.ndarray):
        tensor = torch.from_numpy(tensor)
    if tensor.device.type != "cpu":
        raise ValueError(f"native collectives take CPU tensors, got one on {tensor.device}")
    return tensor.contiguous()


def _ptr(tensor: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def _frame(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors of any shapes and dtypes as one uint8 buffer: a count, then
    per tensor its dtype name, shape and bytes."""
    parts = [struct.pack("!I", len(tensors))]
    for t in tensors:
        name = str(t.dtype).split(".", 1)[1].encode()
        data = t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
        parts.append(struct.pack(f"!B{len(name)}sB{t.dim()}qQ", len(name), name,
                                 t.dim(), *t.shape, len(data)))
        parts.append(data)
    return torch.frombuffer(bytearray(b"".join(parts)), dtype=torch.uint8)


def _unframe(buf: bytes) -> List[torch.Tensor]:
    (count,) = struct.unpack_from("!I", buf)
    offset, out = 4, []
    for _ in range(count):
        (name_len,) = struct.unpack_from("!B", buf, offset)
        name = buf[offset + 1 : offset + 1 + name_len].decode()
        offset += 1 + name_len
        (ndim,) = struct.unpack_from("!B", buf, offset)
        *shape, nbytes = struct.unpack_from(f"!{ndim}qQ", buf, offset + 1)
        offset += 1 + 8 * ndim + 8
        dtype = getattr(torch, name)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"not a torch dtype in a framed buffer: {name!r}")
        data = torch.frombuffer(bytearray(buf[offset : offset + nbytes]), dtype=torch.uint8)
        out.append(data.view(dtype).reshape(shape))
        offset += nbytes
    return out


class ProcessGroupNative(ProcessGroup):
    """Native-backend resizable process group over CPU tensors."""

    def __init__(self, timeout: float = 60.0) -> None:
        super().__init__()
        self._timeout = timeout
        self._lib = _native.load()
        self._handle: Optional[int] = None
        self._rank = 0
        self._world_size = 1
        self._errored_exc: Optional[Exception] = None
        self._ops: Optional["queue.Queue"] = None
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def configure(
        self, store_addr: str, replica_id: str, rank: int, world_size: int
    ) -> None:
        self._teardown()
        self._errored_exc = None
        self._rank = rank
        self._world_size = world_size
        hostport, _, prefix = store_addr.partition("/")
        handle = self._lib.tpuft_collective_new()
        rc = self._lib.tpuft_collective_configure(
            handle, hostport.encode(), prefix.encode(), rank, world_size,
            int(self._timeout * 1000),
        )
        if rc != 0:
            err = self._lib.tpuft_collective_last_error(handle).decode()
            self._lib.tpuft_collective_free(handle)
            error = RuntimeError(f"native configure failed: {err}")
            self._errored_exc = error
            raise error
        self._handle = handle
        self._ops = queue.Queue()
        self._worker = threading.Thread(
            target=self._worker_loop, args=(self._ops,), daemon=True,
            name=f"native-pg-{replica_id}-{rank}",
        )
        self._worker.start()

    def _worker_loop(self, ops: "queue.Queue") -> None:
        while True:
            try:
                item = ops.get()
                if item is None:
                    return
                item()
            except BaseException as e:  # noqa: BLE001 — worker must survive
                # Ops capture their own exceptions into their Work future
                # (_submit); anything landing here is a bug in that capture,
                # and a dead worker would hang every later collective until
                # timeout — log and keep serving.
                logger.exception("native pg op-worker: op escaped its Work: %s", e)

    def _teardown(self) -> None:
        with self._lock:
            handle, self._handle = self._handle, None
            ops, self._ops = self._ops, None
        if handle is not None:
            # ::shutdown()s the sockets, failing any op blocked inside a C
            # call (fds stay allocated until the free below).
            self._lib.tpuft_collective_shutdown(handle)
        if ops is not None:
            ops.put(None)
        worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout=10.0)
        if handle is not None:
            if worker is not None and worker.is_alive():
                # The op thread is still inside the native call: freeing now
                # would be a use-after-free. Leak the handle (its sockets are
                # shut down, so the op fails and the worker exits).
                logger.warning("native pg worker still running; leaking handle")
            else:
                self._lib.tpuft_collective_free(handle)

    def abort(self) -> None:
        self._errored_exc = self._errored_exc or RuntimeError("process group aborted")
        self._teardown()

    def shutdown(self) -> None:
        self._teardown()

    def errored(self) -> Optional[Exception]:
        return self._errored_exc

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    # -- plumbing ----------------------------------------------------------

    def _submit(self, fn: Callable[[int], object]) -> Work:
        if self._errored_exc is not None:
            raise RuntimeError(f"process group in error state: {self._errored_exc}")
        fut: Future = Future()
        # Read handle/queue and enqueue under the lock so a concurrent
        # _teardown cannot slip its None sentinel in between (which would
        # strand this op's future unresolved forever).
        with self._lock:
            handle, ops = self._handle, self._ops
            if handle is None or ops is None:
                raise RuntimeError("process group not configured")

            def run() -> None:
                try:
                    fut.set_result(fn(handle))
                except BaseException as e:  # noqa: BLE001
                    if self._errored_exc is None:
                        self._errored_exc = (
                            e if isinstance(e, Exception) else RuntimeError(str(e))
                        )
                    fut.set_exception(e)

            ops.put(run)
        return Work(fut)

    def _check(self, rc: int, handle: int, op: str) -> None:
        if rc != 0:
            err = self._lib.tpuft_collective_last_error(handle).decode()
            raise RuntimeError(f"native {op} failed: {err}")

    # -- collectives -------------------------------------------------------

    def allreduce(self, tensors: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM) -> Work:
        tensors = [_host(t) for t in tensors]
        timeout_ms = int(self._timeout * 1000)

        def run(handle: int) -> List[torch.Tensor]:
            out = []
            for tensor in tensors:
                buf = tensor.clone()
                self._check(
                    self._lib.tpuft_collective_allreduce(
                        handle, _ptr(buf), buf.numel(), _dtype_code(buf.dtype),
                        _REDUCE_CODES[op], timeout_ms,
                    ),
                    handle, "allreduce",
                )
                out.append(buf)
            return out

        return self._submit(run)

    def allgather(self, tensors: Sequence[torch.Tensor]) -> Work:
        # Ranks may hold tensors of other shapes: gather each rank's framed
        # length first, then the frames padded to the longest.
        blob = _frame([_host(t) for t in tensors])
        timeout_ms = int(self._timeout * 1000)

        def run(handle: int) -> List[List[torch.Tensor]]:
            n = self._world_size
            length = torch.tensor([blob.numel()], dtype=torch.int64)
            lengths = torch.zeros(n, dtype=torch.int64)
            self._check(
                self._lib.tpuft_collective_allgather(
                    handle, _ptr(length), _ptr(lengths), 1,
                    _dtype_code(torch.int64), timeout_ms,
                ),
                handle, "allgather",
            )
            max_len = int(lengths.max())
            padded = torch.zeros(max_len, dtype=torch.uint8)
            padded[: blob.numel()] = blob
            gathered = torch.zeros(n * max_len, dtype=torch.uint8)
            self._check(
                self._lib.tpuft_collective_allgather(
                    handle, _ptr(padded), _ptr(gathered), max_len,
                    _dtype_code(torch.uint8), timeout_ms,
                ),
                handle, "allgather",
            )
            raw = gathered.numpy().tobytes()
            return [
                _unframe(raw[r * max_len : r * max_len + int(lengths[r])])
                for r in range(n)
            ]

        return self._submit(run)

    def broadcast(self, tensors: Sequence[torch.Tensor], root: int = 0) -> Work:
        tensors = [_host(t) for t in tensors]
        timeout_ms = int(self._timeout * 1000)

        def run(handle: int) -> List[torch.Tensor]:
            out = []
            for tensor in tensors:
                buf = tensor.clone()
                self._check(
                    self._lib.tpuft_collective_broadcast(
                        handle, _ptr(buf), buf.numel(), _dtype_code(buf.dtype), root,
                        timeout_ms,
                    ),
                    handle, "broadcast",
                )
                out.append(buf)
            return out

        return self._submit(run)

    def alltoall(self, tensors: Sequence[torch.Tensor]) -> Work:
        tensors = [_host(t) for t in tensors]
        if len(tensors) != self._world_size:
            raise ValueError(f"alltoall requires {self._world_size} tensors")
        if len({tuple(t.shape) for t in tensors}) != 1 or len({t.dtype for t in tensors}) != 1:
            raise ValueError("native alltoall requires uniform shapes/dtypes")
        timeout_ms = int(self._timeout * 1000)

        def run(handle: int) -> List[torch.Tensor]:
            stacked = torch.cat([t.reshape(-1) for t in tensors])
            out = torch.empty_like(stacked)
            per_rank = tensors[0].numel()
            self._check(
                self._lib.tpuft_collective_alltoall(
                    handle, _ptr(stacked), _ptr(out), per_rank,
                    _dtype_code(stacked.dtype), timeout_ms,
                ),
                handle, "alltoall",
            )
            return [
                out[r * per_rank : (r + 1) * per_rank].reshape(tensors[0].shape).clone()
                for r in range(self._world_size)
            ]

        return self._submit(run)

    def barrier(self) -> Work:
        timeout_ms = int(self._timeout * 1000)

        def run(handle: int) -> None:
            self._check(self._lib.tpuft_collective_barrier(handle, timeout_ms), handle, "barrier")

        return self._submit(run)
