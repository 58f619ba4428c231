"""The traced window (--trace 1): what the per-layer readers read.

- The device: torch.profiler with CUDA activity only, over the window. Its
  kernel, copy and memset rows give the device's busy time (the union of
  their intervals) and the time by kernel name. A `torch.cuda._sleep`
  marker launched on an idle card at the window's start ties the trace's
  clock to the host's.
- The host: a sampler thread reads every thread's Python stack every
  SAMPLE_S and charges the interval to the innermost frame that lies in
  dgraph_tpu_torch/ (its file, relative to the package), for every thread
  but the sampler and the main thread. A thread whose innermost frame waits
  in `threading` is not charged. cProfile is not used: on Python 3.12 one
  profiler serves the whole process, and it cannot tell threads apart.
- Counters: the Node's metrics registry, read before and after.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from pathlib import Path

SAMPLE_S = 0.002
PORT = "dgraph_tpu_torch"
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
WAITING = ("threading.py", "queue.py", "selectors.py")


def _label(frame) -> str | None:
    if Path(frame.f_code.co_filename).name in WAITING:
        return None
    f = frame
    while f is not None:
        parts = Path(f.f_code.co_filename).parts
        if PORT in parts:
            rel = "/".join(parts[len(parts) - parts[::-1].index(PORT):])
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return None


class Sampler(threading.Thread):
    def __init__(self):
        super().__init__(name="graphbench-sampler", daemon=True)
        self.stop_ev = threading.Event()
        self.seconds = collections.Counter()     # label -> thread-seconds
        self.timeline: list[tuple[float, str | None]] = []
        self.skip = {threading.main_thread().ident}

    def run(self):
        self.skip.add(threading.get_ident())
        last = time.perf_counter()
        while not self.stop_ev.wait(SAMPLE_S):
            now = time.perf_counter()
            dt, last = now - last, now
            tops = collections.Counter()
            for tid, frame in sys._current_frames().items():
                if tid in self.skip:
                    continue
                lab = _label(frame)
                if lab is not None:
                    self.seconds[lab] += dt
                    tops[lab] += 1
            self.timeline.append(
                (now, tops.most_common(1)[0][0] if tops else None))

    def stop(self):
        self.stop_ev.set()
        self.join()


class Window:
    """Everything a metric reader may read; filled by Tracer.stop."""

    def __init__(self):
        self.window_s = 0.0
        self.completed = 0
        self.device_events: list[tuple[str, float, float]] = []  # s, s
        self.busy_s = None
        self.host_seconds: dict[str, float] = {}
        self.timeline: list = []
        self.counters: dict[str, int] = {}
        self.gaps: list[tuple[float, float]] = []


def _ns(event, what: str) -> int:
    """A kineto event's start or duration in ns (older builds give us)."""
    f = getattr(event, f"{what}_ns", None)
    return f() if f is not None else getattr(event, f"{what}_us")() * 1000


def _counter_values(node) -> dict[str, int]:
    return {k: c.value for k, c in list(node.metrics.counters.items())}


class Tracer:
    def __init__(self, node, device):
        self.node, self.device = node, device
        self.win = Window()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._c0 = _counter_values(self.node)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.sampler = Sampler()
        self.sampler.start()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self, completed: int):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.sampler.stop()
        self.prof.__exit__(None, None, None)
        w = self.win
        w.window_s = t1 - self.t0
        w.completed = completed
        w.host_seconds = dict(self.sampler.seconds)
        w.timeline = self.sampler.timeline
        c1 = _counter_values(self.node)
        w.counters = {k: v - self._c0.get(k, 0) for k, v in c1.items()}
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            events.append((e.name(), _ns(e, "start") * 1e-9,
                           _ns(e, "duration") * 1e-9))
        marks = [s for name, s, _ in events if MARKER in name]
        if not marks:
            raise RuntimeError("graphbench: the window's marker kernel is "
                               "not in the device trace")
        off = min(marks) - self.t0      # device time = host time + off
        lo, hi = self.t0 + off, t1 + off
        w.device_events = [(n, s - off, d) for n, s, d in events
                           if MARKER not in n and s >= lo and s < hi]
        busy, gaps, cur_s, cur_e = 0.0, [], None, self.t0
        for _, s, d in sorted(w.device_events, key=lambda x: x[1]):
            e = min(s + d, t1)
            if cur_s is not None and s <= cur_e:
                cur_e = max(cur_e, e)
                continue
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, t1))
        w.busy_s, w.gaps = busy, gaps
        return w


def breakdown(w: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by
    what the host was doing (the sampler's most frequent frame in the
    gap)."""
    by_op = collections.Counter()
    for name, _, d in w.device_events:
        by_op[name[:120]] += d
    idle = collections.Counter()
    times = [t for t, _ in w.timeline]
    import bisect
    for a, b in w.gaps:
        if b <= a:
            continue
        i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        labs = collections.Counter(lab for _, lab in w.timeline[i:j])
        idle[labs.most_common(1)[0][0] if labs else "(no sample)"] += b - a
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k if k is not None else "(host outside the port)",
                           v] for k, v in idle.most_common(top)]}
