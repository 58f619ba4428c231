"""Shared by the readers of counters that only some versions of the
program keep: whether the program's Node registry pre-registers a counter,
and a duration counter's delta over the traced window in ms a request. A
program whose registry lacks the counter gives no reading; a window it did
not move reads 0."""


def registered(counter: str) -> bool:
    """True when the program under test pre-registers `counter`."""
    try:
        from dgraph_tpu_torch.utils.metrics import Registry
    except ImportError:
        return False
    return counter in Registry().counters


def ms_per_query(w, counter: str):
    """A nanosecond counter's delta, ms a request completed in the
    window."""
    if w.completed <= 0 or not registered(counter):
        return None
    return w.counters.get(counter, 0) * 1e-6 / w.completed
