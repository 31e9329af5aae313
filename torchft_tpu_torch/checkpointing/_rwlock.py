"""Readers-writer lock with timeouts (counterpart of
torchft_tpu/checkpointing/_rwlock.py).

Guards the live state_dict against concurrent optimizer mutation while a
checkpoint is being staged for a peer. Writer-preferring: a waiting writer
blocks new readers. The reference also reports each hold to its runtime
lock-order detector (``utils/lockcheck``), which the port does not carry
yet (ROADMAP queue A4).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Generator

__all__ = ["RWLock"]


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def r_acquire(self, timeout: float = -1) -> bool:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._writer and self._writers_waiting == 0,
                timeout=None if timeout < 0 else timeout,
            )
            if not ok:
                return False
            self._readers += 1
        return True

    def r_release(self) -> None:
        with self._cond:
            assert self._readers > 0, "r_release without matching r_acquire"
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def w_acquire(self, timeout: float = -1) -> bool:
        with self._cond:
            self._writers_waiting += 1
            try:
                ok = self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0,
                    timeout=None if timeout < 0 else timeout,
                )
                if not ok:
                    return False
                self._writer = True
            finally:
                self._writers_waiting -= 1
        return True

    def w_release(self) -> None:
        with self._cond:
            assert self._writer, "w_release without matching w_acquire"
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def r_lock(self, timeout: float = -1) -> Generator[None, None, None]:
        if not self.r_acquire(timeout):
            raise TimeoutError(f"read lock not acquired within {timeout}s")
        try:
            yield
        finally:
            self.r_release()

    @contextmanager
    def w_lock(self, timeout: float = -1) -> Generator[None, None, None]:
        if not self.w_acquire(timeout):
            raise TimeoutError(f"write lock not acquired within {timeout}s")
        try:
            yield
        finally:
            self.w_release()
