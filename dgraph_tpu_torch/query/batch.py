"""Batched multi-query device execution: amortize the fixed dispatch+sync.

Port of dgraph_tpu/query/batch.py. Three families batch, as in JAX: expand
(concatenated frontiers through task.gather_on_device), vector (stacked query
matrices through one ops/vector.topk_candidates_batch) and recurse (stacked
seed masks through ops/pull_bfs.recurse_fused_multi, which runs K1/K2
level-major for the whole batch). The JAX batch pads the stacked seed
masks, the concatenated frontier and the stacked query matrix to
power-of-two sizes so that batch compositions share compiled XLA programs;
nothing compiles per shape here, and a padded slot would be wasted device
work, so the port packs exactly the members.

PERF.md is unambiguous that once single-query kernels are fast, the fixed
per-dispatch relay sync dominates every number — and under load the qcache
DispatchGate (width 4) *serializes* device work, so every query pays that
fixed latency alone and device-path QPS is gate-width-bound instead of
scaling with concurrency. This module is the classic serving-stack answer
(the same reason inference servers batch requests into one kernel launch):

  * DeviceBatcher — a short-window collector at the Executor._dispatch /
    DispatchGate seam. A task that classifies as a device-class kernel
    joins an open batch of COMPATIBLE in-flight tasks (same predicate CSR
    object — which pins the snapshot version, object identity IS the
    cache/invalidation granularity here exactly as in qcache — same
    kernel class, same static capacity class) or opens one. The batch
    leader waits a few ms for companions (fire-immediately when the
    device is idle), launches ONE batched kernel through the gate, and
    de-multiplexes per-caller TaskResults that are byte-identical to solo
    execution (the host tails are the SAME functions the solo path runs:
    task.finish_uid_expand / task.set_similar_result).
  * Three kernel families batch:
      expand  — concatenated frontiers through the solo expand's own
                device gather (task.gather_on_device), classified by its
                own route (task.expand_route); the counts split the flat
                target stream back per task;
      vector  — stacked [B, D] query matrices through one top-k product
                (ops/vector.topk_candidates_batch);
      recurse — stacked seed masks through the multi-source fused recurse
                (ops/pull_bfs.recurse_fused_multi).
  * Composition with the cache tiers: singleflight (qcache) dedupes
    IDENTICAL in-flight tasks — only the flight leader reaches the
    batcher; the batcher packs DISTINCT compatible ones. Tasks that miss
    classification (host-cutover expands, overlay/mesh tablets, cold-tier
    tablets, value predicates, IVF/overlay/mesh vector views) run solo on
    the existing path.
  * Deadlines: a task whose remaining budget cannot cover the window plus
    the expected batched step (the gate's per-class EWMA) bypasses the
    window and dispatches solo — where the existing lifeline machinery
    (gate shed / deadline checks) applies unchanged.

Observability: dgraph_batch_* counters + occupancy histogram + per-reason
incompatibility gauge on /debug/metrics, and the batched device_kernel
spans carry the batch size.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

from dgraph_tpu_torch.obs import costs, otrace
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import locks


def kernel_klass(q) -> str:
    """Coarse kernel class of one TaskQuery for the gate's per-class EWMA
    (host-cutover expands, mesh steps, and vector scans have wildly
    different step times — one global estimate misestimates all of them)."""
    if q.frontier is None:
        if q.func is not None and q.func[0].lower() == "similar_to":
            return "vector"
        return "root"
    return "expand"


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

class _ExpandWork:
    """One classified device-class expand: the reverse-resolved task and
    its route (task.expand_route), whose host first pass, where it made
    one, the batched gather uploads instead of ranking again."""

    __slots__ = ("pd", "csr", "q", "frontier", "route", "metrics")

    def __init__(self, pd, csr, q, frontier, route, metrics):
        self.pd, self.csr, self.q = pd, csr, q
        self.frontier, self.route = frontier, route
        self.metrics = metrics


class _RecurseWork:
    __slots__ = ("g", "seeds_mask")

    def __init__(self, g, seeds_mask):
        self.g, self.seeds_mask = g, seeds_mask


class _VectorWork:
    __slots__ = ("vi", "vec", "k", "metrics")

    def __init__(self, vi, vec, k, metrics):
        self.vi, self.vec, self.k, self.metrics = vi, vec, k, metrics


def classify(snap, schema, q):
    """Classify one TaskQuery for batching.

    Returns (key, kind, work) for a batchable device-class step — key is
    hashable and pins the exact kernel the batch launches (object identity
    of the device arrays + static capacity class) — or (None, reason,
    None) for shapes that stay on the solo path. Anything the solo path
    would reject with a typed error also returns None: the solo execution
    raises it with the exact message the caller expects."""
    fname = q.func[0].lower() if q.func else None
    if q.frontier is None:
        if fname != "similar_to":
            return None, "root_func", None
        key, kind, work = _classify_vector(snap, schema, q)
    else:
        key, kind, work = _classify_expand(snap, schema, q)
    if key is not None:
        from dgraph_tpu_torch import tenancy

        # tenants never share CSR/index objects (namespace views keep
        # PredData identity per storage tablet), so id() in the key
        # already separates them — the explicit tenant component makes
        # the isolation structural rather than incidental, and keys the
        # batch-window metrics per namespace
        t = tenancy.current()
        if t:
            key = key + (t,)
    return key, kind, work


def _classify_expand(snap, schema, q):
    from dgraph_tpu_torch.query import task as taskmod
    from dgraph_tpu_torch.utils.types import TypeID

    q = taskmod.resolve_reverse(q)
    pd = snap.pred(q.attr)
    if pd is None:
        return None, "no_pred", None
    if not (pd.type_id == TypeID.UID or pd.csr is not None or q.reverse):
        return None, "value_pred", None
    csr = pd.rev_csr if q.reverse else pd.csr
    if csr is None:
        return None, "empty_csr", None
    frontier = np.asarray(q.frontier, dtype=np.int64)
    # the solo path's own route, a consult: a cold tablet is no more
    # uploaded by a batched kernel than by a solo one, and its cold serve
    # is counted where the solo path serves it
    route = taskmod.expand_route(csr, frontier, q.cutover)
    if route.kind != "device":
        return None, ("empty_frontier" if route.kind == "empty"
                      else route.kind), None
    # id(csr) pins BOTH the tablet and the snapshot version: assemblers
    # replace (never mutate) CSR objects on any visible change, and the
    # work object holds a strong reference, so the id cannot be recycled
    # while the batch is open
    return ("expand", id(csr)), "expand", \
        _ExpandWork(pd, csr, q, frontier, route,
                    getattr(snap, "metrics", None))


def _classify_vector(snap, schema, q):
    from dgraph_tpu_torch.ops import vector as vops
    from dgraph_tpu_torch.query import task as taskmod
    from dgraph_tpu_torch.storage import vecindex as vecmod

    attr = q.attr[1:] if q.attr.startswith("~") else q.attr
    pd = snap.pred(attr)
    spec = schema.vector_spec(attr)
    if pd is None or spec is None:
        return None, "vector_solo", None
    try:
        vec, k = taskmod.parse_similar_args(pd, list(q.func[1]))
    except Exception:
        return None, "vector_solo", None      # solo raises the typed error
    if len(vec) != spec.dim:
        return None, "vector_solo", None
    vi = pd.vecindex
    if vi is None:
        return None, "vector_solo", None      # empty index: solo shortcut
    if vi.is_overlay or getattr(vi, "_mesh", None) is not None \
            or getattr(vi, "ivf", None) is not None:
        return None, "vector_variant", None
    if vi.n * vi.dim <= vecmod.HOST_SCAN_MAX:
        return None, "host_path", None
    if vi.prefer_host():
        # cold vector tablet: vecindex.search serves the exact host scan
        return None, "vector_cold", None
    kprime = vops.k_capacity(k, vops.row_capacity(vi.n))
    # kprime is the candidate capacity every member of one batch shares
    # (different final k values still share a batch when their candidate
    # capacity class matches)
    return ("vector", id(vi), kprime), "vector", \
        _VectorWork(vi, vec, k, getattr(snap, "metrics", None))


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("work", "solo", "dl", "lg", "event", "result", "error",
                 "batch_size")

    def __init__(self, work, solo=None) -> None:
        self.work = work
        self.solo = solo        # zero-arg solo execution (1-entry batches)
        self.dl = dl.current()  # the submitting caller's deadline
        # the submitting caller's cost ledger: a batched kernel acts for
        # SEVERAL requests, so its cost is apportioned to the members'
        # ledgers by slot size (obs/costs.py) — the follower thread is
        # parked inside its task scope, so attr attribution stays exact
        self.lg = costs.current()
        self.event = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        self.batch_size = 0


class _Batch:
    __slots__ = ("entries", "full", "closed")

    def __init__(self, entry: _Entry) -> None:
        self.entries = [entry]
        self.full = threading.Event()
        self.closed = False


# follower safety net: a leader always sets every entry's event in its
# finally block, so this only fires on catastrophic leader death
_FOLLOWER_WAIT_S = 120.0


class DeviceBatcher:
    """Short-window collector of compatible in-flight device tasks.

    gate=None (the wire worker's serve_task has no DispatchGate) runs the
    batched kernel directly and uses its own in-flight count for the
    idle-fire check."""

    def __init__(self, gate=None, metrics=None, window_ms: float = 2.0,
                 max_batch: int = 16, idle_fire: bool = True) -> None:
        from dgraph_tpu_torch.utils.metrics import Registry

        self.gate = gate
        self.metrics = metrics if metrics is not None else Registry()
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self.max_batch = max(int(max_batch), 1)
        # fire-immediately when the device is idle: a batch leader skips
        # the window when nothing is running or queued at the gate, so
        # concurrency-1 traffic pays ZERO added latency. Tests disable it
        # to force deterministic full batches.
        self.idle_fire = idle_fire
        self._lock = locks.Lock("batch.DeviceBatcher._lock")
        self._open: dict[tuple, _Batch] = {}
        self._own_inflight = 0
        # hint_burst(): until this monotonic instant, leaders wait the
        # window even on an idle device — a caller that KNOWS compatible
        # companions are imminent (the live notifier re-evaluating a
        # coalesced commit window) trades one window of latency for
        # packing instead of firing the first re-eval solo
        self._burst_until = 0.0
        m = self.metrics
        self._formed = m.counter("dgraph_batch_formed_total")
        self._tasks = m.counter("dgraph_batch_tasks_total")
        self._occupancy = m.histogram("dgraph_batch_occupancy")
        self._window_waits = m.counter("dgraph_batch_window_waits_total")
        self._bypass = m.counter("dgraph_batch_deadline_bypass_total")
        self._incompat = m.keyed("dgraph_batch_incompatible")

    # ------------------------------------------------------------- plumbing

    def _gate_run(self, fn: Callable, klass: str):
        if self.gate is not None:
            return self.gate.run(fn, klass=klass)
        return fn()

    def _timed_gate_run(self, fn: Callable, klass: str):
        """(result, kernel ms) of one gated batched launch — with the
        leader's gate QUEUE wait subtracted (it is booked as
        gate_wait_ms; double-counting it as device ms would flag every
        shape as regressed whenever the gate is contended). Runs inside
        a kernel window so the gate's injected-fault charges — already
        inside dt, which _charge apportions to every member — are not
        ALSO booked on the leader's ledger."""
        lg = costs.current()
        if lg is None:
            t0 = time.perf_counter()
            out = self._gate_run(fn, klass)
            return out, (time.perf_counter() - t0) * 1e3
        with lg.kernel_window():
            gw0 = lg.gate_wait_ms
            t0 = time.perf_counter()
            out = self._gate_run(fn, klass)
            dt = (time.perf_counter() - t0) * 1e3
            dt = max(dt - (lg.gate_wait_ms - gw0), 0.0)
        return out, dt

    def _busy(self) -> bool:
        if self.gate is not None:
            return self.gate.busy()
        return self._own_inflight > 0

    def hint_burst(self) -> None:
        """Declare that a burst of concurrent submissions is imminent
        (within ~one window): leaders arriving before the hint expires
        hold the collection window open even when the device is idle."""
        self._burst_until = time.perf_counter() + max(self.window_s, 0.0)

    def _deadline_bypasses(self, kind: str) -> bool:
        """True when the caller's remaining budget cannot cover the window
        plus the expected batched step — it dispatches solo instead, where
        the gate's own shed/deadline machinery applies unchanged."""
        rem = dl.remaining()
        if rem is None:
            return False
        est = self.gate.expected_step(kind) if self.gate is not None else 0.0
        if rem < self.window_s + est:
            self._bypass.inc()
            otrace.event("batch_bypass", kind=kind,
                         remaining_ms=round(rem * 1000, 1))
            costs.note("batch_bypass")
            return True
        return False

    @staticmethod
    def _charge(entries: list[_Entry], kernel: str, dt_ms: float,
                weights: list[float] | None = None,
                h2d: int = 0, d2h: int = 0) -> None:
        """Apportion one batched kernel's wall ms + transfer bytes to the
        members' ledgers by slot weight (frontier degree sum for expand,
        equal split otherwise)."""
        n = len(entries)
        total_w = sum(weights) if weights else float(n)
        if total_w <= 0:
            total_w = float(n)
            weights = None
        for i, en in enumerate(entries):
            if en.lg is None:
                continue
            frac = (weights[i] / total_w) if weights else 1.0 / n
            en.lg.add_kernel(kernel, dt_ms * frac,
                             h2d=int(h2d * frac), d2h=int(d2h * frac))
            if n > 1:
                en.lg.note("batched")

    def _submit(self, key: tuple, kind: str, work,
                runner: Callable[[list[_Entry]], None], solo=None):
        """Join an open compatible batch or lead a new one. The leader
        waits the window (unless the device is idle or the batch fills),
        freezes the batch, runs `runner` (which must fill every entry's
        result or error), and wakes the followers. A batch of ONE runs its
        solo closure instead — identical kernels, spans, and compiled
        programs as the pre-batching path for unaccompanied traffic."""
        entry = _Entry(work, solo)
        with self._lock:
            b = self._open.get(key)
            if b is not None and not b.closed and \
                    len(b.entries) < self.max_batch:
                b.entries.append(entry)
                if len(b.entries) >= self.max_batch:
                    b.full.set()
                leader = False
            else:
                b = _Batch(entry)
                self._open[key] = b
                leader = True
        if not leader:
            rem = dl.remaining()
            wait_s = _FOLLOWER_WAIT_S if rem is None else \
                min(_FOLLOWER_WAIT_S, max(rem, 0.0) + 0.1)
            if not entry.event.wait(wait_s):
                # own budget gone while the batch still runs: typed
                # DeadlineExceeded (the lifeline contract: never a hang
                # past the budget), the batch result is discarded
                dl.check(f"batched {kind} dispatch")
                raise RuntimeError(
                    f"batched {kind} dispatch leader never completed")
            otrace.event("batched", kind=kind, size=entry.batch_size)
            if entry.error is not None:
                raise entry.error
            return entry.result
        try:
            if self.window_s > 0 and \
                    not (self.idle_fire and not self._busy()
                         and time.perf_counter() >= self._burst_until):
                self._window_waits.inc()
                t0 = time.perf_counter()
                # dgraph: allow(deadline-wait) leader window wait is
                # bounded by the ~2ms collection window constant; tight
                # budgets bypassed the window entirely upstream
                b.full.wait(self.window_s)
                # continuous collection: while the device is busy (a step
                # running or queued at the gate) the window is free — the
                # batch would only sit in the gate queue anyway, so keep
                # it open and collecting until the slot is imminent
                # (~one expected step) or it fills. The device never
                # idles waiting on a window; the window only bounds the
                # wait when firing immediately is actually possible.
                cap = self.window_s + (
                    self.gate.expected_step(kind)
                    if self.gate is not None else 0.0)
                while (not b.full.is_set()) and self._busy() and \
                        time.perf_counter() - t0 < cap:
                    # dgraph: allow(deadline-wait) bounded by `cap` (one
                    # window + one expected step) in the loop condition
                    b.full.wait(self.window_s)
        finally:
            with self._lock:
                b.closed = True
                if self._open.get(key) is b:
                    del self._open[key]
                self._own_inflight += 1
        entries = b.entries
        try:
            if len(entries) == 1 and entries[0].solo is not None:
                entries[0].result = entries[0].solo()
            else:
                # the batch acts for SEVERAL callers: run it under the
                # most permissive member's deadline (unbudgeted if any
                # member is), so a tight-budget leader's context cannot
                # shed work the other members had ample time for
                dls = [en.dl for en in entries]
                batch_dl = None if any(d is None for d in dls) else \
                    max(dls, key=lambda d: d.expires)
                with dl.adopt(batch_dl):
                    runner(entries)
        except BaseException as e:
            # a failure of the BATCH (gate shed, device error) fails every
            # member that has no result yet — fair, because the shed was
            # judged against the most permissive member's budget; per-task
            # host-tail failures are assigned per entry inside the runner
            for en in entries:
                if en.result is None and en.error is None:
                    en.error = e
        finally:
            with self._lock:
                self._own_inflight -= 1
            n = len(entries)
            self._formed.inc()
            self._tasks.inc(n)
            self._occupancy.observe(float(n))
            for en in entries:
                en.batch_size = n
                en.event.set()
        otrace.event("batched", kind=kind, size=entry.batch_size)
        if entry.error is not None:
            raise entry.error
        return entry.result

    # --------------------------------------------------------------- entries

    # classification-miss reasons that mean the solo step runs HOST-side
    # work (sub-ms): they feed the gate's "host" EWMA class instead of
    # polluting the device-class estimates ("expand" at ~100ms relay sync
    # vs ~1ms host gathers is exactly the two-tail misestimation the
    # per-class split exists to fix)
    _SOLO_KLASS = {
        "root_func": "host", "no_pred": "host", "value_pred": "host",
        "empty_csr": "host", "empty_frontier": "host", "host_path": "host",
        "vector_solo": "host", "cold_tier": "host",
        "vector_cold": "host",
    }

    def dispatch(self, snap, schema, q, solo: Callable):
        """The Executor._dispatch seam: batch a compatible device-class
        task or run `solo(q, klass=...)` (the existing gate-wrapped
        process_task; klass None falls back to the coarse kernel_klass)."""
        key, kind, work = classify(snap, schema, q)
        if key is None:
            self._incompat.inc(kind)
            return solo(q, klass=self._SOLO_KLASS.get(kind))
        if self._deadline_bypasses(kind):
            return solo(q, klass=kind)
        runner = self._run_expand if kind == "expand" else self._run_vector
        return self._submit(key, kind, work, runner,
                            solo=lambda: solo(q, klass=kind))

    def dispatch_recurse(self, g, seeds_mask, depth: int, allow_loop: bool,
                         solo: Callable):
        """The fused-recurse seam (query/recurse.py): compatible concurrent
        traversals (same PullGraph — which pins tablet + snapshot — same
        depth, same loop rule) stack their seed masks into ONE multi-source
        recurse_fused_multi run. `solo` is the ungated single-query
        recurse_fused closure."""
        key = ("recurse", id(g), depth, allow_loop)
        if self._deadline_bypasses("recurse"):
            return self._gate_run(solo, "recurse")
        work = _RecurseWork(g, seeds_mask)

        def runner(entries: list[_Entry]) -> None:
            self._run_recurse(entries, depth, allow_loop)

        return self._submit(key, "recurse", work, runner,
                            solo=lambda: self._gate_run(solo, "recurse"))

    # --------------------------------------------------------------- runners

    def _run_expand(self, entries: list[_Entry]) -> None:
        """task.gather_on_device over the concatenated frontiers, under
        the gate; the flat targets, fetched off the card once after it
        (task.UidMatrix), split back per task by the counts that came
        back, then task.finish_uid_expand runs the identical host
        tail per task — so each member's TaskResult is byte-identical to
        solo execution."""
        from dgraph_tpu_torch.query import task as taskmod

        works = [e.work for e in entries]
        csr = works[0].csr
        uids = np.concatenate([w.frontier for w in works])
        routes = [w.route for w in works]
        # the members' host rows go up where every route carries them;
        # else the card ranks the concatenated frontier as a whole
        route = taskmod.ExpandRoute("device") \
            if any(r.rows is None for r in routes) else taskmod.ExpandRoute(
                "device", np.concatenate([r.rows for r in routes]),
                np.concatenate([r.deg for r in routes]),
                sum(r.need for r in routes))
        with costs.kernel("batch.expand", charge=False,
                          batch=len(entries)) as ck:
            (matrix, _total, h2d, d2h), dt_ms = self._timed_gate_run(
                lambda: taskmod.gather_on_device(csr, uids, route, None,
                                                 False, works[0].metrics,
                                                 ck=ck), "expand")
            # each member's first slot, and its first edge, in the batch
            slot = np.cumsum([0] + [len(w.frontier) for w in works])
            edge = matrix.offsets[slot]
            self._charge(entries, "batch.expand", dt_ms,
                         weights=np.diff(edge).astype(float).tolist(),
                         h2d=h2d, d2h=d2h)
        flat, offs = matrix.flat, matrix.offsets
        for i, e in enumerate(entries):
            w = e.work
            part = taskmod.UidMatrix(flat[edge[i]: edge[i + 1]],
                                     offs[slot[i]: slot[i + 1] + 1] - edge[i])
            try:
                e.result = taskmod.finish_uid_expand(
                    w.pd, w.q, w.frontier,
                    taskmod.apply_first(part, w.q.first),
                    int(part.offsets[-1]))
            except BaseException as err:
                # a poisoned task fails typed; the rest of the batch is
                # unaffected (its expansion was independent by slot)
                e.error = err

    def _run_vector(self, entries: list[_Entry]) -> None:
        """Stacked [B, D] query matrix through one top-k product; the
        per-query float32 candidate supersets feed the SAME host float64
        (distance, uid) re-rank as the solo path (storage/vecindex), so
        each member's final k is byte-identical to solo execution. The
        matrix holds exactly the B members (no power-of-two padding)."""
        import torch

        from dgraph_tpu_torch.ops import vector as vops
        from dgraph_tpu_torch.query import task as taskmod
        from dgraph_tpu_torch.storage import vecindex as vx

        vi = entries[0].work.vi
        kprime = max(vops.k_capacity(e.work.k,
                                     vops.row_capacity(vi.n))
                     for e in entries)
        nbatch = len(entries)
        Q = np.stack([e.work.vec for e in entries]).astype(np.float32)
        mat, norms, _subs = vi.device()
        dr = torch.zeros(0, dtype=torch.int32)      # no dead rows (plain vi)

        def kernel():
            nd, rows = vops.topk_candidates_batch(
                mat, norms, torch.from_numpy(Q).to(mat.device), vi.n,
                dr, k=kprime, metric=vi.metric)
            return nd.cpu().numpy(), rows.cpu().numpy()

        from dgraph_tpu_torch.utils.faults import FaultError

        try:
            with costs.kernel("batch.vector_topk", charge=False,
                              rows=int(vi.n), k=kprime, batch=nbatch) as ck:
                (nd_h, rows_h), dt_ms = self._timed_gate_run(kernel,
                                                             "vector")
                d2h = int(nd_h.nbytes + rows_h.nbytes)
                self._charge(entries, "batch.vector_topk", dt_ms,
                             h2d=int(Q.nbytes), d2h=d2h)
                ck.set(h2d=int(Q.nbytes), d2h=d2h)
        except FaultError:
            # injected residency.h2d_upload fault: each member answers
            # through vecindex.search, whose own fallback serves the
            # byte-identical host float64 scan
            for e in entries:
                w = e.work
                try:
                    uids, dists = vx.search(vi, w.vec, w.k,
                                            metrics=w.metrics)
                    res = taskmod.TaskResult()
                    taskmod.set_similar_result(res, uids, dists)
                    e.result = res
                except BaseException as err:
                    e.error = err
            return
        for i, e in enumerate(entries):
            w = e.work
            try:
                if w.metrics is not None:
                    w.metrics.counter("dgraph_vector_searches_total").inc()
                rows = rows_h[i][nd_h[i] > -np.inf]
                res = taskmod.TaskResult()
                if len(rows):
                    subs, d = vx._rescore(vi, rows,
                                          w.vec.astype(np.float64))
                    uids, dists = vx._rank(d, subs, w.k)
                else:
                    uids = np.zeros(0, np.int64)
                    dists = np.zeros(0, np.float64)
                taskmod.set_similar_result(res, uids, dists)
                e.result = res
            except BaseException as err:
                e.error = err

    def _run_recurse(self, entries: list[_Entry], depth: int,
                     allow_loop: bool) -> None:
        """Stacked seed masks through recurse_fused_multi; slice b of the
        stacked outputs is bit-identical to a solo recurse_fused call (the
        per-level ops are integer/boolean). Each entry receives its
        (masks_p, traversed, fresh) triple; fresh stays a device slice
        until a lazy uidMatrix materialization fetches it."""
        import torch

        from dgraph_tpu_torch.ops import pull_bfs as pb

        g = entries[0].work.g
        nbatch = len(entries)
        seeds = torch.stack([e.work.seeds_mask for e in entries])

        def kernel():
            return pb.recurse_fused_multi(
                g.in_src_pad, g.in_src_pad_d, g.in_iptr_rank, g.subjects,
                g.in_subjects, seeds, depth=depth, chunks=g.chunks,
                chunks_d=g.chunks_d, allow_loop=allow_loop)

        with costs.kernel("batch.recurse", charge=False, depth=depth,
                          batch=nbatch):
            (masks_p, trav, fresh), dt_ms = self._timed_gate_run(
                kernel, "recurse")
            self._charge(entries, "batch.recurse", dt_ms)
        for i, e in enumerate(entries):
            e.result = (masks_p[i], trav[i], fresh[i])
