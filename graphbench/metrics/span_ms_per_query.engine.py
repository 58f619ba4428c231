"""Self time of the program's engine-layer spans (obs/otrace.py
SPAN_LAYERS), ms a request: dgraph_span_self_ns_engine_total's delta."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_span_counters").per_query(
        w, "dgraph_span_self_ns_engine_total", 1e-6)
