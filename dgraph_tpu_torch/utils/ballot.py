"""Shared election loop: the mechanical half of a Raft-style ballot.

Port of dgraph_tpu/utils/ballot.py (pure host code).

Both replication planes run the same failure-detector loop — leaders ping
on a fixed cadence, followers campaign after a randomized silence window —
while their vote/grant rules and promotion effects differ (workers grant on
the (max_commit_ts, log_len) up-to-date rule and install WAL shipping;
zeros grant on the shipped state sequence and reload Zero from replicated
state). This module owns the LOOP; the planes own the RPCs.

Reference: conn/node.go:47-105 (etcd-raft tick/election loop, CheckQuorum),
redesigned as one reusable loop for `parallel/remote.WorkerService` and
`coord/zero_service.ZeroReplica` (the two hand-rolled copies had
already diverged once).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable


class BallotLoop:
    """Run `send_pings()` every ping_s while `is_leader()`; otherwise run
    `campaign()` once `leader_contact()` has been silent longer than a
    randomized timeout (re-randomized per round, Raft's split-vote
    avoidance). `campaign` may raise — the loop must survive anything."""

    def __init__(self, *, is_leader: Callable[[], bool],
                 send_pings: Callable[[], None],
                 campaign: Callable[[], None],
                 leader_contact: Callable[[], float],
                 touch_contact: Callable[[], None],
                 ping_s: float, timeout_range: tuple[float, float],
                 tick_s: float = 0.1,
                 stop_event: threading.Event | None = None) -> None:
        self._is_leader = is_leader
        self._send_pings = send_pings
        self._campaign = campaign
        self._leader_contact = leader_contact
        self._touch_contact = touch_contact
        self._ping_s = ping_s
        self._timeout_range = timeout_range
        self._tick_s = tick_s
        # an externally-owned event makes stop-before-start safe: a loop
        # constructed after the event was set exits on its first tick
        self._stop = stop_event if stop_event is not None \
            else threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is None:
            # dgraph: allow(ctxvar-copy) detached ballot tick bg loop
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        timeout = random.uniform(*self._timeout_range)
        last_ping = 0.0
        while not self._stop.wait(self._tick_s):
            now = time.monotonic()
            if self._is_leader():
                if now - last_ping >= self._ping_s:
                    last_ping = now
                    try:
                        self._send_pings()
                    except Exception:
                        pass
                continue
            if now - self._leader_contact() > timeout:
                try:
                    self._campaign()
                except Exception:
                    pass
                timeout = random.uniform(*self._timeout_range)
                self._touch_contact()


def tally(votes_granted: int, member_count: int) -> bool:
    """Majority of the FULL member set (dead members count against)."""
    return votes_granted >= member_count // 2 + 1
