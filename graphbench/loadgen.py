"""The one traffic generator: it reads a traffic mix's file and drives a
Node's query call in a closed or an open loop.

A mix file (traffic/<mix>.json) holds:
  loop      "closed" (each client sends its next request when the last one
            is answered) or "open" (requests are sent when due)
  clients   closed: the clients; open: the client threads that send
  rate      open: requests a second, Poisson arrivals
  warmup    requests of each kind sent before the window
  requests  [{"kind": <requests/<kind>.py>, "share": <of all requests>,
              "params": {...}}]

Every seed gets the same work: an open loop's inter-arrival gaps are one
fixed draw, scaled so that exactly rate x seconds requests fall in the
window; the kinds come in exact shares (a closed loop's in each block of
BLOCK requests); each request's size quantile, which a kind may use to
pick its size, comes from one fixed draw; the seed orders them and draws
each request's own arguments (uids, names).
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np

from graphbench import spec

ARRIVALS_SEED = 0      # the fixed draw of inter-arrival gaps
BLOCK = 20             # a closed loop's kinds come in exact shares per block
SIZES_SEED = 1         # the fixed draw of each request's size quantile


class Mix:
    def __init__(self, traffic: dict, data: dict):
        self.t = traffic
        self.kinds = [r["kind"] for r in traffic["requests"]]
        self.mods = [spec.plugin("requests", k) for k in self.kinds]
        self.params = [r.get("params", {}) for r in traffic["requests"]]
        self.shares = np.asarray([float(r["share"])
                                  for r in traffic["requests"]])
        self.data = data

    def make(self, rng, i: int, u: float) -> dict:
        """Request kind i; `u` in [0, 1) is its size quantile, which a kind
        may use to pick how large a request it makes."""
        req = self.mods[i].make(rng, self.data, self.params[i], u)
        req["kind"] = i
        return req

    def requests(self, count: int, rng) -> list[dict]:
        """`count` requests: kinds in exact shares and size quantiles from
        one fixed draw, both in the seed's order."""
        sizes = np.random.default_rng(SIZES_SEED).random(count)
        rng.shuffle(sizes)
        return [self.make(rng, int(k), float(u)) for k, u in
                zip(self.kind_order(count, rng), sizes)]

    def kind_order(self, count: int, rng) -> np.ndarray:
        """`count` kind indices in exact shares (largest remainders), in
        the seed's order."""
        want = self.shares / self.shares.sum() * count
        base = np.floor(want).astype(np.int64)
        rest = np.argsort(-(want - base), kind="stable")[: count - base.sum()]
        base[rest] += 1
        order = np.repeat(np.arange(len(base)), base)
        rng.shuffle(order)
        return order

    def judge(self, ref, req, resp):
        return self.mods[req["kind"]].judge(ref, req, resp)

    def answer(self, ref, req):
        return self.mods[req["kind"]].answer(ref, req)


def arrivals(rate: float, seconds: float, rng) -> np.ndarray:
    """Due times in [0, seconds): round(rate x seconds) of them, from one
    fixed draw of exponential gaps, put in the seed's order."""
    count = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(ARRIVALS_SEED).exponential(1.0, count + 1)
    rng.shuffle(gaps)
    due = np.cumsum(gaps)[:count] / gaps.sum() * seconds
    return due


class Record:
    __slots__ = ("req", "due", "sent", "done", "resp", "error")

    def __init__(self, req, due):
        self.req, self.due = req, due
        self.sent = self.done = None
        self.resp = self.error = None


def _call(call, rec: Record, t0: float) -> None:
    rec.sent = time.perf_counter() - t0
    try:
        rec.resp = call(rec.req["text"])
    except Exception as e:                 # a failed request: it is counted
        rec.error = f"{type(e).__name__}: {e}"
    rec.done = time.perf_counter() - t0


def _blocks(mix: Mix, rng):
    while True:
        yield from (int(k) for k in mix.kind_order(BLOCK, rng))


def closed_loop(call, mix: Mix, rng, seconds: float, clients: int,
                grace_s: float) -> list:
    """Each client sends its next request when the last one is answered,
    until `seconds` have passed; the kinds come in exact shares in each
    block of BLOCK requests, so a window's mix does not hang on the seed.
    Returns the records (due = when sent)."""
    lock = threading.Lock()
    order = _blocks(mix, rng)
    sizes = np.random.default_rng(SIZES_SEED)
    records: list[Record] = []
    t0 = time.perf_counter()

    def client():
        while True:
            with lock:
                if time.perf_counter() - t0 >= seconds:
                    return
                rec = Record(mix.make(rng, next(order),
                                      float(sizes.random())), None)
                records.append(rec)
            _call(call, rec, t0)
            rec.due = rec.sent

    threads = [threading.Thread(target=client, name=f"graphbench-client{i}",
                                daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + grace_s)
    return records


def open_loop(call, reqs: list, due: np.ndarray, clients: int,
              seconds: float, grace_s: float) -> tuple[list, list]:
    """Send reqs[i] at due[i] seconds after the start, each on the first
    free one of `clients` client threads. Returns the records and how late
    the generator handed each request over (seconds).
    Answers are waited for until `grace_s` past the window; a request not
    answered by then is left to its thread and counts as never answered."""
    records = [Record(r, float(d)) for r, d in zip(reqs, due)]
    late: list[float] = []
    todo: queue.Queue = queue.Queue()
    left = threading.Semaphore(0)
    t0 = time.perf_counter()

    def client():
        while True:
            rec = todo.get()
            if rec is None:
                return
            _call(call, rec, t0)
            left.release()

    for i in range(clients):
        threading.Thread(target=client, name=f"graphbench-client{i}",
                         daemon=True).start()
    for rec in records:
        wait = rec.due - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - t0 - rec.due)
        todo.put(rec)
    end = t0 + seconds + grace_s
    for _ in records:
        if not left.acquire(timeout=max(0.0, end - time.perf_counter())):
            break
    while True:                 # what was never sent is never answered
        try:
            todo.get_nowait()
        except queue.Empty:
            break
    for _ in range(clients):
        todo.put(None)
    return records, late


def percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list."""
    k = max(1, math.ceil(q / 100.0 * len(sorted_values)))
    return sorted_values[k - 1]
