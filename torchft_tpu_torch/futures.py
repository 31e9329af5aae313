"""Fault-tolerant future/timeout engine (counterpart of
torchft_tpu/futures.py, as far as the Manager uses it).

Role-equivalent of upstream torchft's ``torchft/futures.py``: a singleton
timer service that can bound any future or code region with a deadline, plus
a watchdog thread that hard-exits the process if the timer service itself
wedges — the last line of defense against undetectable hangs
(upstream torchft torchft/futures.py:97-120).

Env: ``TPUFT_WATCHDOG_TIMEOUT_SEC`` (default 30).
"""

from __future__ import annotations

import heapq
import itertools
import os
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional

__all__ = [
    "future_timeout",
]

WATCHDOG_TIMEOUT_SEC = float(os.environ.get("TPUFT_WATCHDOG_TIMEOUT_SEC", "30"))


class _TimerHandle:
    __slots__ = ("cancelled",)

    def __init__(self) -> None:
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class _TimeoutManager:
    """Single scheduler thread firing deadline callbacks, watched by a
    watchdog that hard-exits the process if the scheduler stalls."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._heap: list = []  # (deadline, seq, handle, callback)
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._last_tick = time.monotonic()
        self._watchdog_enabled = True

    def _ensure_started(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tpuft-timeout-manager"
            )
            self._thread.start()
            self._watchdog = threading.Thread(
                target=self._run_watchdog, daemon=True, name="tpuft-watchdog"
            )
            self._watchdog.start()

    def schedule(self, delay: float, callback: Callable[[], None]) -> _TimerHandle:
        self._ensure_started()
        handle = _TimerHandle()
        deadline = time.monotonic() + delay
        with self._lock:
            heapq.heappush(self._heap, (deadline, next(self._seq), handle, callback))
            self._lock.notify()
        return handle

    def _run(self) -> None:
        while True:
            with self._lock:
                self._last_tick = time.monotonic()
                if not self._heap:
                    self._lock.wait(timeout=1.0)
                    continue
                deadline, _, handle, callback = self._heap[0]
                now = time.monotonic()
                if deadline > now:
                    self._lock.wait(timeout=min(deadline - now, 1.0))
                    continue
                heapq.heappop(self._heap)
            if not handle.cancelled:
                try:
                    callback()
                except Exception:  # noqa: BLE001
                    # A failing timeout callback must not kill the scheduler.
                    import traceback

                    traceback.print_exc()

    def _run_watchdog(self) -> None:
        while True:
            time.sleep(WATCHDOG_TIMEOUT_SEC / 4)
            if not self._watchdog_enabled:
                continue
            stalled = time.monotonic() - self._last_tick
            if stalled > WATCHDOG_TIMEOUT_SEC:
                sys.stderr.write(
                    f"tpuft watchdog: timeout scheduler stalled {stalled:.1f}s "
                    f"(> {WATCHDOG_TIMEOUT_SEC}s); exiting\n"
                )
                sys.stderr.flush()
                self._exit(1)
                # Only reachable when the exit seam is mocked (tests): end
                # the watchdog thread instead of re-firing forever.
                return

    def _exit(self, code: int) -> None:  # test seam
        # os._exit, not sys.exit: SystemExit raised in a non-main thread
        # only kills that thread — the watchdog contract is a process
        # hard-exit when the timeout scheduler is wedged.
        os._exit(code)


_TIMEOUT_MANAGER = _TimeoutManager()


def future_timeout(fut: "Future[Any]", timeout: float) -> "Future[Any]":
    """A future mirroring ``fut`` but failing with TimeoutError after
    ``timeout`` seconds (reference: futures.py:146-191)."""
    out: Future = Future()

    def on_timeout() -> None:
        if not out.done():
            out.set_exception(TimeoutError(f"future timed out after {timeout}s"))

    handle = _TIMEOUT_MANAGER.schedule(timeout, on_timeout)

    def on_done(f: "Future[Any]") -> None:
        handle.cancel()
        if out.done():
            return
        err = f.exception()
        if err is not None:
            try:
                out.set_exception(err)
            except Exception:  # noqa: BLE001  (already resolved by timeout race)
                pass
        else:
            try:
                out.set_result(f.result())
            except Exception:  # noqa: BLE001
                pass

    fut.add_done_callback(on_done)
    return out
