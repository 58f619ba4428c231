"""WaterMark: minimum-unfinished-index tracker.

Copy of dgraph_tpu/utils/watermark.py for the PyTorch port.

Reference semantics: x/watermark.go:66-213 — Begin(k)/Done(k) mark an index
pending/finished; DoneUntil() is the highest index such that every index at
or below it is finished; WaitForMark(k) blocks until DoneUntil >= k. The
reference runs a goroutine over a channel of marks; here a heap under a
condition variable gives the same contract synchronously (no event loop to
leak in embedded nodes).

Used for applied/synced watermarks: e.g. "all WAL records up to index k are
applied" gates snapshotting and follower catch-up the same way the
reference gates reads on the applied watermark.
"""

from __future__ import annotations

import heapq
import threading
from collections import Counter


class WaterMark:
    def __init__(self, name: str = "") -> None:
        self.name = name
        self._cv = threading.Condition()
        self._pending: Counter[int] = Counter()   # index -> open begins
        self._heap: list[int] = []                # candidate minimums
        self._done_until = 0
        self._last_index = 0

    def begin(self, index: int) -> None:
        with self._cv:
            self._last_index = max(self._last_index, index)
            if self._pending[index] == 0:
                heapq.heappush(self._heap, index)
            self._pending[index] += 1

    def done(self, index: int) -> None:
        with self._cv:
            if self._pending.get(index, 0) <= 0:
                raise ValueError(f"done({index}) without begin")
            self._pending[index] -= 1
            if self._pending[index] == 0:
                del self._pending[index]
            self._advance_locked()

    def _advance_locked(self) -> None:
        moved = False
        while self._heap and self._pending.get(self._heap[0], 0) == 0:
            idx = heapq.heappop(self._heap)
            if idx > self._done_until:
                self._done_until = idx
                moved = True
        if not self._heap and self._last_index > self._done_until \
                and not self._pending:
            # everything begun has finished
            self._done_until = self._last_index
            moved = True
        if moved:
            self._cv.notify_all()

    def set_done_until(self, index: int) -> None:
        """Jump the watermark (reference SetDoneUntil — only valid when not
        interleaved with begin/done)."""
        with self._cv:
            if self._pending:
                raise ValueError("set_done_until with marks pending")
            self._done_until = max(self._done_until, index)
            self._last_index = max(self._last_index, index)
            self._cv.notify_all()

    def done_until(self) -> int:
        with self._cv:
            return self._done_until

    def last_index(self) -> int:
        with self._cv:
            return self._last_index

    def wait_for_mark(self, index: int, timeout: float | None = None) -> bool:
        """Block until done_until >= index; returns False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._done_until >= index,
                                     timeout=timeout)
