"""The kernel tier's host predecessor walk, ms a request: the
`shortest_walk` span's time (dgraph_shortest_walk_ns_total's delta)."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_program_counters").ms_per_query(
        w, "dgraph_shortest_walk_ns_total")
