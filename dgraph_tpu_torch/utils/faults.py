"""Faultline: seeded fault injection at the system's real seams.

Copy of dgraph_tpu/utils/faults.py for the PyTorch port, without the
trace event a firing point emits (the port has no tracer yet).

Reference analog: the reference proves its failure handling with systest
clusters that kill/partition real processes; conn/pool.go Echo failures
and Raft CheckQuorum are the detection side. This registry is the
injection side for one process: named fault POINTS installed at the RPC
serve/send seams (worker serve_task, zero RPC send), disk I/O
(store WAL write, ingest spill), and the device-dispatch seam
(qcache.DispatchGate), each firing with a configured probability from a
DETERMINISTIC per-registry PRNG — the same seed replays the same fault
schedule, so chaos runs are debuggable, not flaky.

Modes:
  error  — raise FaultError (a ConnectionError: transport-shaped, so the
           retry/breaker machinery treats it like a real network fault)
  delay  — sleep `delay_s` then proceed (slow disk / slow peer)
  drop   — sleep `delay_s` (default 0) then raise FaultError — a request
           that disappeared; with a delay it models a blackholed send
           that only the caller's deadline bounds.

Activation:
  * env:  DGRAPH_TPU_FAULTS="worker.serve_task:error:0.1,disk.wal_write:
          delay:1.0:0.05"  (name:mode:p[:delay_s][:count]) and
          DGRAPH_TPU_FAULTS_SEED=42 — parsed at import for every process.
  * flag: `serve --faults ... --faults_seed N` (dgraph_tpu/__main__.py).
  * HTTP: POST /debug/faults {"install": {...}} / {"clear": true} — the
          chaos harness drives live processes through this.
  * code: faults.GLOBAL.install(...) in tests.

Fire sites pass their node's metrics registry so injections show as
dgraph_fault_injected_total on that node's /metrics. The disabled fast
path is one truthiness check of an empty dict — free on hot paths.
"""

from __future__ import annotations

import os
import random
import threading
import time


class FaultError(ConnectionError):
    """An injected transport-shaped failure."""


# fault-point names wired into the codebase (docs/ops.md runbook lists
# these; installing an unknown name is allowed but never fires)
POINTS = (
    "worker.serve_task",    # RPC serve seam: group task server
    "worker.mutate",        # RPC serve seam: group mutation apply
    "zero.rpc",             # RPC send seam: any ZeroClient call
    "rpc.send",             # RPC send seam: RemoteWorker.process_task
    "disk.wal_write",       # store WAL append/commit records
    "disk.fsync",           # the sync-write durability seam only (the
    # fsync a commit pays); a delay here emulates durable-disk sync cost
    # (bench_write's sync sweep — loopback-fs fsync is unrepresentative)
    "disk.spill",           # out-of-core ingest spill-run writes
    "device.dispatch",      # device-dispatch gate critical section
    "device.step",          # inside a held gate slot: slow device program
    # placement subsystem (coord/placement.py)
    "zero.rebalance_decide",  # controller tick, before acting on a pick
    "move.chunk_ship",      # per-chunk in the tablet move/replica stream
    "replica.delta_ship",   # replica freshness delta ship
    # device working-set manager (storage/residency.py): the H2D upload
    # seam every warm->hbm promotion crosses; query paths catch the
    # injected error and serve the byte-identical host gather
    "residency.h2d_upload",
)


class _Point:
    __slots__ = ("name", "mode", "p", "delay_s", "count", "fired")

    def __init__(self, name: str, mode: str, p: float,
                 delay_s: float, count: int | None) -> None:
        if mode not in ("error", "delay", "drop"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.name = name
        self.mode = mode
        self.p = float(p)
        self.delay_s = float(delay_s)
        self.count = count                 # remaining fires (None = forever)
        self.fired = 0

    def snapshot(self) -> dict:
        return {"mode": self.mode, "p": self.p, "delay_s": self.delay_s,
                "remaining": self.count, "fired": self.fired}


class FaultRegistry:
    """Named fault points with one seeded PRNG. The registry is usually
    the module GLOBAL (one per process, like the env the reference's
    systest kills operate on); tests may build private instances."""

    def __init__(self, seed: int | None = None) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, _Point] = {}
        self._rng = random.Random(seed)
        self.seed = seed

    def reseed(self, seed: int | None) -> None:
        with self._lock:
            self._rng = random.Random(seed)
            self.seed = seed

    def install(self, name: str, mode: str = "error", p: float = 1.0,
                delay_s: float = 0.0, count: int | None = None) -> None:
        pt = _Point(name, mode, p, delay_s, count)
        with self._lock:
            self._points[name] = pt

    def clear(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._points.clear()
            else:
                self._points.pop(name, None)

    def configure(self, spec: str) -> None:
        """Parse 'name:mode:p[:delay_s][:count]' entries separated by
        commas (the env/flag format)."""
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            parts = item.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault spec {item!r} "
                                 "(want name:mode[:p[:delay_s[:count]]])")
            name, mode = parts[0], parts[1]
            # empty optional fields keep their defaults ("a:error::0.5"
            # sets delay without restating p)
            p = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
            delay_s = float(parts[3]) if len(parts) > 3 and parts[3] \
                else 0.0
            count = int(parts[4]) if len(parts) > 4 and parts[4] else None
            self.install(name, mode, p, delay_s, count)

    def snapshot(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "points": {n: p.snapshot()
                               for n, p in self._points.items()}}

    def fire(self, name: str, m=None) -> None:
        """Evaluate one fault point. Fast no-op when nothing is installed.
        `m` is the local metrics Registry (dgraph_fault_injected_total)."""
        if not self._points:
            return
        with self._lock:
            pt = self._points.get(name)
            if pt is None:
                return
            if pt.count is not None and pt.count <= 0:
                return
            if pt.p < 1.0 and self._rng.random() >= pt.p:
                return
            pt.fired += 1
            if pt.count is not None:
                pt.count -= 1
            mode, delay_s = pt.mode, pt.delay_s
        if m is not None:
            try:
                m.counter("dgraph_fault_injected_total").inc()
            except Exception:
                pass
        from . import deadline as dl

        if delay_s > 0:
            # an in-process delay is synchronous on the request thread, so
            # the deadline cannot preempt it — clamp the injected sleep to
            # the caller's remaining budget (+ a hair past it, so the next
            # wait point sees the budget as spent), the way a real slow
            # step is bounded by the RPC timeout across the wire
            rem = dl.remaining()
            if rem is not None:
                delay_s = min(delay_s, max(rem, 0.0) + 0.005)
            time.sleep(delay_s)
        if mode in ("error", "drop"):
            raise FaultError(f"injected fault at {name} ({mode})")


GLOBAL = FaultRegistry()


def fire(name: str, m=None) -> None:
    """Evaluate `name` against the process-global registry."""
    GLOBAL.fire(name, m)


def init_from_env() -> None:
    """Arm the global registry from DGRAPH_TPU_FAULTS[_SEED] (called at
    import so every subcommand/process honors the env contract)."""
    seed = os.environ.get("DGRAPH_TPU_FAULTS_SEED")
    if seed is not None:
        try:
            GLOBAL.reseed(int(seed))
        except ValueError:
            pass
    spec = os.environ.get("DGRAPH_TPU_FAULTS")
    if spec:
        GLOBAL.configure(spec)


init_from_env()
