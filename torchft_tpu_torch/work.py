"""Async work handles for collectives.

``Work`` plays the role of ``torch.distributed.Work`` in the reference;
``_DummyWork`` is the universal "skip this collective" value
(upstream torchft torchft/work.py:9-20) the manager substitutes when a replica
is not participating or the group has errored.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, Optional

__all__ = ["Work", "_DummyWork"]


class Work:
    """Handle for an asynchronous collective; resolves to the op's result."""

    def __init__(self, future: "Future[Any]") -> None:
        self._future = future

    @classmethod
    def completed(cls, value: Any) -> "Work":
        fut: Future = Future()
        fut.set_result(value)
        return cls(fut)

    @classmethod
    def failed(cls, error: BaseException) -> "Work":
        fut: Future = Future()
        fut.set_exception(error)
        return cls(fut)

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Blocks until done; returns the result or raises the op's error."""
        return self._future.result(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        return self._future.exception(timeout)

    def add_done_callback(self, fn: Callable[["Future[Any]"], None]) -> None:
        self._future.add_done_callback(fn)

    def then(self, fn: Callable[[Any], Any]) -> "Work":
        """Chains a transform over the result; errors propagate."""
        out: Future = Future()

        def callback(fut: "Future[Any]") -> None:
            try:
                out.set_result(fn(fut.result()))
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        self._future.add_done_callback(callback)
        return Work(out)

    @classmethod
    def gather(cls, works: "list[Work]") -> "Work":
        """Combines several works into one resolving to the list of their
        results (in input order). The first failure wins and propagates."""
        out: Future = Future()
        results: list = [None] * len(works)
        state = {"remaining": len(works), "failed": False}
        lock = threading.Lock()

        if not works:
            out.set_result([])
            return cls(out)

        def make_callback(index: int) -> Callable[["Future[Any]"], None]:
            def callback(fut: "Future[Any]") -> None:
                err = fut.exception()
                with lock:
                    if state["failed"]:
                        return
                    if err is not None:
                        state["failed"] = True
                        out.set_exception(err)
                        return
                    results[index] = fut.result()
                    state["remaining"] -= 1
                    finished = state["remaining"] == 0
                if finished:
                    out.set_result(list(results))

            return callback

        for index, work in enumerate(works):
            work._future.add_done_callback(make_callback(index))
        return cls(out)

    def with_error_handler(
        self, handler: Callable[[Exception], None], fallback: Any
    ) -> "Work":
        """On failure: reports the error to ``handler`` and resolves to
        ``fallback`` instead (the error-swallowing contract)."""
        out: Future = Future()

        def callback(fut: "Future[Any]") -> None:
            err = fut.exception()
            if err is None:
                out.set_result(fut.result())
            else:
                try:
                    handler(err if isinstance(err, Exception) else RuntimeError(str(err)))
                finally:
                    out.set_result(fallback)

        self._future.add_done_callback(callback)
        return Work(out)


class _DummyWork(Work):
    """Already-completed no-op work holding a fixed result."""

    def __init__(self, result: Any) -> None:
        fut: Future = Future()
        fut.set_result(result)
        super().__init__(fut)
