"""Device-idle time while the host's innermost open span was a traversal-layer
span, ms a request (graphbench/metrics/_span_idle.py)."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_span_idle").ms_per_query(w, "traversal")
