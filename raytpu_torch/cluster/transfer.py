"""The transfer plane's flow control, copied from
``raytpu/cluster/transfer.py:55-94``: a bytes-based in-flight window
shared by every concurrent transfer in the process. The port has no
object plane yet, so its only user is the KV handoff
(:func:`raytpu_torch.inference.disagg.pull_kv_prefix`)."""

from __future__ import annotations

import threading
from typing import Optional

from raytpu_torch.cluster import constants as tuning


class ByteWindow:
    """Bytes-based in-flight budget (the reference pull manager's
    ``max_bytes_in_flight``). ``acquire(n)`` blocks until ``n`` more
    payload bytes fit; a request larger than the whole budget is admitted
    alone (never deadlocks a jumbo chunk), and ``release`` wakes all
    waiters so small chunks can pack the window densely."""

    def __init__(self, budget: int):
        self.budget = max(1, int(budget))
        self._used = 0
        self._cv = threading.Condition()

    def acquire(self, n: int) -> None:
        with self._cv:
            while self._used > 0 and self._used + n > self.budget:
                self._cv.wait()
            self._used += n

    def release(self, n: int) -> None:
        with self._cv:
            self._used -= n
            self._cv.notify_all()

    def in_flight(self) -> int:
        with self._cv:
            return self._used


_win: Optional[ByteWindow] = None
_win_lock = threading.Lock()


def _window() -> ByteWindow:
    """Process-wide window shared by every concurrent transfer, both
    directions — aggregate, not per-object, like the reference."""
    global _win
    with _win_lock:
        if _win is None:
            _win = ByteWindow(tuning.TRANSFER_WINDOW_BYTES)
        return _win
