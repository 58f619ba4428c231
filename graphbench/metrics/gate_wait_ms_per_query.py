"""Time requests waited at the program's dispatch gate, ms a request:
dgraph_dispatch_wait_ns_total's delta."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_span_counters").per_query(
        w, "dgraph_dispatch_wait_ns_total", 1e-6)
