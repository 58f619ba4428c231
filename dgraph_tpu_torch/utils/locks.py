"""lockdep: runtime lock-ordering verification.

Copy of dgraph_tpu/utils/locks.py for the PyTorch port.

Reference analog: the reference runs its whole CI under `go test -race`;
Go's runtime cannot prove lock-ORDER safety, but the Linux kernel's
lockdep can — and this is that idea for the Python side of this codebase.
Every instrumented lock belongs to a named CLASS (striped locks share an
index-suffixed family name); each acquisition while other classes are
held records directed edges held-class -> new-class into one
process-global order graph. The first acquisition that closes a cycle in
that graph is a provable deadlock SCHEDULE (two threads interleaving the
two witness stacks wedge forever), reported with both witness sites —
even though this particular run never deadlocked. That is the whole
point: chaos runs detect inversions without having to lose the race.

Arming contract (near-zero overhead, byte-identical when disarmed):

  * `Lock(name)` / `RLock(name)` are FACTORIES. Disarmed (the default)
    they return the raw `threading.Lock()` / `threading.RLock()` object —
    the production binary runs the exact same primitives it always did,
    zero wrappers, zero overhead.
  * `arm()` (or env DGRAPH_TPU_LOCKDEP=1) must run BEFORE the locks are
    constructed; tests arm in a fixture, then build their nodes. Armed
    factories return instrumented wrappers that feed the global state.
  * Violations raise `LockOrderError` at the acquisition that closed the
    cycle when `arm(raise_on_cycle=True)` (the test default), and are
    always appended to `violations()` so harnesses can assert emptiness.

Reentrant acquisition of the SAME instance (RLock) is not an ordering
and records nothing. Two DIFFERENT instances of the same class nested
(e.g. two stripes of a striped lock family) are reported as
`same-class-nesting`: stripe order is hash-derived, so any nesting is a
latent ABBA unless the call site sorts stripes first.

Adopted by: storage store (via utils/sync.SafeLock), the residency
manager + its striped upload locks, the dispatch gate, the device
batcher, and the placement controller. The static half of this invariant
is dgraph_tpu/analysis (rule lock-order) over `with` nesting.
"""

from __future__ import annotations

import os
import sys
import threading


class LockOrderError(AssertionError):
    """A lock acquisition closed a cycle in the global order graph."""


# wrapper modules whose frames are never the interesting witness site:
# this module itself and utils/sync.py (SafeLock forwards acquire here —
# without the skip every store-lock witness would print sync.py:<n>)
_WRAPPER_FILES = ("locks.py", "sync.py")


def _site(depth: int = 3) -> str:
    """filename:lineno of the acquiring frame (cheap: no stack object).
    Walks past wrapper frames so witness sites name the REAL caller."""
    try:
        f = sys._getframe(depth)
        while f is not None and \
                os.path.basename(f.f_code.co_filename) in _WRAPPER_FILES:
            f = f.f_back
        if f is None:
            return "?"
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "?"


class _State:
    """Process-global order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # a -> {b: (witness site holding a, witness site acquiring b)}
        self.graph: dict[str, dict[str, tuple[str, str]]] = {}
        self.same_class_seen: set[str] = set()
        self.violations: list[dict] = []
        self.raise_on_cycle = True
        self.tls = threading.local()
        # bumped by reset(): a background thread still holding an
        # instrumented lock across a reset/re-arm boundary (daemon loops
        # outliving one test into the next) must not inject its stale
        # held entries as edges into the fresh graph
        self.epoch = 0

    def held(self) -> list:
        """This thread's stack of (class key, instance id, site, epoch)."""
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h

    def _path(self, src: str, dst: str) -> list[str] | None:
        """DFS: a path src -> ... -> dst in the order graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.graph.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _report(self, kind: str, key: str, cycle: list[str],
                site: str, witness: tuple[str, str] | None) -> None:
        v = {"kind": kind, "key": key, "cycle": cycle, "site": site,
             "witness": witness}
        self.violations.append(v)
        if self.raise_on_cycle:
            wtxt = f" (forward order first seen at {witness[0]} -> " \
                   f"{witness[1]})" if witness else ""
            raise LockOrderError(
                f"lock-order {kind}: acquiring {key!r} at {site} closes "
                f"the cycle {' -> '.join(cycle)}{wtxt}")

    def acquired(self, key: str, inst: int, site: str) -> None:
        """Record one successful acquisition by this thread. MUST run
        after the real acquire succeeded (the lock is held while we
        mutate the graph under self.lock — lockdep's own lock is a leaf:
        nothing is acquired while holding it)."""
        held = self.held()
        epoch = self.epoch
        # stale-epoch entries (held across a reset()) are invisible: they
        # belong to a graph that no longer exists
        live = [e for e in held if e[3] == epoch]
        if any(k == key and i == inst for k, i, _, _ in live):
            held.append((key, inst, site, epoch))  # reentrant: no ordering
            return
        new_edges = []
        for hk, hi, hsite, _ep in live:
            if hk == key:
                # a second INSTANCE of a held class: hash-ordered stripes
                # nesting each other are a latent ABBA by construction
                with self.lock:
                    if key not in self.same_class_seen:
                        self.same_class_seen.add(key)
                        self._report("same-class-nesting", key,
                                     [key, key], site, (hsite, site))
                continue
            new_edges.append((hk, hsite))
        with self.lock:
            for hk, hsite in new_edges:
                row = self.graph.setdefault(hk, {})
                if key not in row:
                    row[key] = (hsite, site)
                    back = self._path(key, hk)
                    if back is not None:
                        self._report("inversion", key, back + [key],
                                     site, self.graph[hk][key])
        held.append((key, inst, site, epoch))

    def released(self, key: str, inst: int) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == key and held[i][1] == inst:
                del held[i]
                return


_STATE = _State()
_armed = False


def armed() -> bool:
    return _armed


def arm(raise_on_cycle: bool = True) -> None:
    """Arm lockdep for locks constructed FROM NOW ON. Tests call this in
    a fixture before building nodes; `reset()` first for a clean graph."""
    global _armed
    _STATE.raise_on_cycle = bool(raise_on_cycle)
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def reset() -> None:
    """Drop the recorded graph + violations (between tests). Bumps the
    epoch so locks still held by surviving background threads cannot
    leak pre-reset orderings into the fresh graph."""
    with _STATE.lock:
        _STATE.graph.clear()
        _STATE.same_class_seen.clear()
        _STATE.violations.clear()
        _STATE.epoch += 1


def violations() -> list[dict]:
    with _STATE.lock:
        return list(_STATE.violations)


def edges() -> dict[str, list[str]]:
    """The observed order graph (for debugging / assertions)."""
    with _STATE.lock:
        return {a: sorted(b) for a, b in _STATE.graph.items()}


class _DepBase:
    """Shared wrapper plumbing over a real threading primitive."""

    __slots__ = ("_lk", "name")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok and _armed:
            try:
                _STATE.acquired(self.name, id(self), _site(2))
            except BaseException:
                self._lk.release()     # never leave the real lock wedged
                raise
        return ok

    def release(self) -> None:
        self._lk.release()
        _STATE.released(self.name, id(self))

    def __enter__(self) -> bool:
        ok = self._lk.acquire()
        if _armed:
            try:
                _STATE.acquired(self.name, id(self), _site(2))
            except BaseException:
                self._lk.release()
                raise
        return ok

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __repr__(self) -> str:
        return f"<lockdep {type(self).__name__} {self.name!r} " \
               f"wrapping {self._lk!r}>"


class _DepLock(_DepBase):
    __slots__ = ()

    def __init__(self, name: str) -> None:
        self._lk = threading.Lock()
        self.name = name


class _DepRLock(_DepBase):
    __slots__ = ()

    def __init__(self, name: str) -> None:
        self._lk = threading.RLock()
        self.name = name

    def locked(self) -> bool:                    # RLock has no .locked()
        if self._lk.acquire(blocking=False):
            self._lk.release()
            return False
        return True


def Lock(name: str):
    """A named mutex: raw `threading.Lock` disarmed, instrumented armed."""
    if _armed:
        return _DepLock(name)
    return threading.Lock()


def RLock(name: str):
    """A named reentrant mutex: raw `threading.RLock` disarmed,
    instrumented armed (reentrant re-acquisition records no ordering)."""
    if _armed:
        return _DepRLock(name)
    return threading.RLock()


if os.environ.get("DGRAPH_TPU_LOCKDEP", "") not in ("", "0"):
    arm(raise_on_cycle=os.environ.get(
        "DGRAPH_TPU_LOCKDEP_RAISE", "1") not in ("", "0"))
