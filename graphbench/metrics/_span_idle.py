"""Shared by the idle readers: the traced window's device-idle time put
down to the program's layers.

Each slice of a gap (`w.gaps`, when no kernel, copy or memset ran on the
card) goes to the layer of the innermost span open at that time on each
host thread, from the program's span ring (dgraph_tpu_torch/obs/otrace.py
`span_log`, stamped on the perf_counter clock the gaps are in). Where k
threads have a span open, each gets 1/k of the slice; a slice with none
open goes to no layer. ms per request completed in the window. No reading
where the ring overwrote entries during the window
(dgraph_span_ring_dropped_total moved) or the program keeps no ring."""

LAYERS = ("node", "engine", "traversal", "device")
DROPPED = "dgraph_span_ring_dropped_total"

# at one instant: spans close, then gaps end, then gaps start, then spans
# open
_CLOSE, _GAP_END, _GAP_START, _OPEN = range(4)


def idle_by_layer(gaps, entries) -> dict[str, float]:
    """Seconds of `gaps` [(start, end)] put down to each layer, from ring
    entries (layer, name, thread id, start, end)."""
    events = [(a, _GAP_START, None) for a, b in gaps if b > a]
    events += [(b, _GAP_END, None) for a, b in gaps if b > a]
    for i, e in enumerate(entries):
        events.append((e[3], _OPEN, i))
        events.append((e[4], _CLOSE, i))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    out = dict.fromkeys(LAYERS, 0.0)
    open_by_tid: dict = {}          # thread id -> [(start, entry index)]
    in_gap = 0
    last = None
    for t, kind, i in events:
        if in_gap and last is not None and t > last:
            busy = [max(s) for s in open_by_tid.values() if s]
            for _start, j in busy:
                lay = entries[j][0]
                if lay in out:
                    out[lay] += (t - last) / len(busy)
        last = t
        if kind == _GAP_START:
            in_gap += 1
        elif kind == _GAP_END:
            in_gap -= 1
        elif kind == _OPEN:
            open_by_tid.setdefault(entries[i][2], []).append(
                (entries[i][3], i))
        else:
            stack = open_by_tid.get(entries[i][2], [])
            key = (entries[i][3], i)
            if key in stack:
                stack.remove(key)
    return out


def ms_per_query(w, layer: str):
    if w.completed <= 0:
        return None
    try:
        from dgraph_tpu_torch.obs import otrace
    except ImportError:
        return None
    span_log = getattr(otrace, "span_log", None)
    if span_log is None or w.counters.get(DROPPED, 0) > 0:
        return None
    gaps = [(a, b) for a, b in w.gaps if b > a]
    if not gaps:
        return 0.0
    entries = span_log(min(a for a, _ in gaps), max(b for _, b in gaps))
    return 1e3 * idle_by_layer(gaps, entries)[layer] / w.completed
