"""Concurrency helpers: the race-detection story (SURVEY §5).

Copy of dgraph_tpu/utils/sync.py for the PyTorch port.

The reference leans on `go test -race` plus x.SafeMutex's AssertLock
(x/lock.go) and liberal x.AssertTrue invariants. Python has no data-race
sanitizer, so the strategy here is:
  1. SafeLock.assert_held() guards on internal methods that REQUIRE the
     caller to hold the lock (misuse fails fast instead of corrupting);
  2. invariant-checking multithreaded stress tests (tests/test_stress.py,
     scaled up via DGRAPH_TPU_STRESS=1) covering the scheduler, the txn
     pipeline, and replication;
  3. single-writer disciplines documented at the structure (e.g. packed
     bases are immutable — mutation replaces, never edits).
"""

from __future__ import annotations

import threading

from . import locks


class SafeLock:
    """RLock that can assert 'the current thread holds me'
    (x/lock.go SafeMutex.AssertLock analog). `name` is the lockdep
    class (utils/locks.py): armed runs record this lock's orderings in
    the global order graph; disarmed it is a raw threading.RLock."""

    def __init__(self, name: str = "sync.SafeLock") -> None:
        self._lock = locks.RLock(name)
        self._owner: int | None = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            self._depth += 1
        return ok

    def release(self) -> None:
        if not self.held_by_me():
            # non-owner misuse: let RLock raise its canonical error without
            # touching the true owner's tracking state
            self._lock.release()
            raise AssertionError("unreachable: RLock.release must raise")
        # mutate tracking while still holding the lock (releasing first
        # would race a new owner's acquire against our owner-clear)
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def assert_held(self) -> None:
        if not self.held_by_me():
            raise AssertionError(
                "lock-discipline violation: caller must hold the lock")
