"""Conflict-keyed mutation scheduler.

Copy of dgraph_tpu/parallel/scheduler.py for the PyTorch port.

Reference semantics: worker/scheduler.go:34-95 — each mutation declares the
conflict keys it touches; a task blocks until no in-flight task holds any of
its keys, then runs; tasks with disjoint key sets run concurrently, tasks
sharing a key run strictly in arrival order.

Our keys are (attr, subject) edge fingerprints (the same granularity the
reference's scheduler uses via DirectedEdge keys) — finer state (shared
index token rows) is protected by per-PostingList locks underneath, so
per-subject serialization is what correctness needs above them.

Exclusive tasks (`S * *` deletes, whose footprint is only known by reading
the store at apply time) behave like a write lock: they wait for every
earlier task and block every later one.

Liveness: tickets are assigned and enqueued atomically under one lock in
global arrival order, so the oldest outstanding ticket always heads each of
its queues and satisfies the exclusive gate — the wait-for graph is acyclic.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterable, TypeVar

from ..utils import deadline as dl
from ..utils.deadline import DeadlineExceeded

T = TypeVar("T")


class Scheduler:
    def __init__(self) -> None:
        self._cv = threading.Condition()
        # key -> FIFO of ticket ids waiting/running; head is the holder
        self._queues: dict[int, deque[int]] = {}
        self._outstanding: set[int] = set()   # all enqueued/running tickets
        self._excl: set[int] = set()          # exclusive subset
        self._next_ticket = 0
        # observability: how many tasks ran, max that ever ran at once
        self.started = 0
        self.max_concurrent = 0
        self._running = 0

    def run(self, keys: Iterable[int], fn: Callable[[], T],
            exclusive: bool = False) -> T:
        """Run fn once its conflict keys (or, for exclusive, the whole
        scheduler) are free; blocks until runnable."""
        keyset = sorted(set(keys))
        with self._cv:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._outstanding.add(ticket)
            if exclusive:
                self._excl.add(ticket)
            else:
                for k in keyset:
                    self._queues.setdefault(k, deque()).append(ticket)

            def runnable() -> bool:
                if exclusive:
                    # oldest outstanding task of any kind
                    return min(self._outstanding) == ticket
                # heads every queue it sits in, and no older exclusive
                return all(self._queues[k][0] == ticket for k in keyset) \
                    and min(self._excl, default=ticket + 1) > ticket

            while not runnable():
                # clamped to the caller's deadline (lifeline contract):
                # a budgeted mutation stuck behind held conflict keys
                # fails typed instead of hanging past its budget — and
                # gives its ticket back so later tasks never wait on a
                # ghost head-of-queue
                if not self._cv.wait(dl.clamp(None)):
                    self._outstanding.discard(ticket)
                    if exclusive:
                        self._excl.discard(ticket)
                    else:
                        for k in keyset:
                            q = self._queues[k]
                            q.remove(ticket)
                            if not q:
                                del self._queues[k]
                    self._cv.notify_all()
                    raise DeadlineExceeded(
                        "mutation scheduler: budget exhausted before "
                        "conflict keys freed")
            self.started += 1
            self._running += 1
            self.max_concurrent = max(self.max_concurrent, self._running)
        try:
            return fn()
        finally:
            with self._cv:
                self._running -= 1
                self._outstanding.discard(ticket)
                if exclusive:
                    self._excl.discard(ticket)
                else:
                    for k in keyset:
                        q = self._queues[k]
                        q.popleft()          # we were the head
                        if not q:
                            del self._queues[k]
                self._cv.notify_all()
