"""Shared by the span-counter readers: the program's own counters (its
Node registry's deltas over the traced window, `w.counters`), a request.
A counter the window lacks reads 0. A program that records no layer spans
(its obs/otrace.py has no `span_log`) gives no reading."""


def recorded() -> bool:
    """True when the program under test records layer spans."""
    try:
        from dgraph_tpu_torch.obs import otrace
    except ImportError:
        return False
    return hasattr(otrace, "span_log")


def per_query(w, counter: str, scale: float = 1.0):
    """The counter's delta over the window, times `scale`, per request
    completed in it."""
    if w.completed <= 0 or not recorded():
        return None
    return w.counters.get(counter, 0) * scale / w.completed
