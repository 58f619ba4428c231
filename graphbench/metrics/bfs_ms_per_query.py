"""The kernel tier's device BFS loop, ms a request: the `shortest_bfs`
span's time (dgraph_shortest_bfs_ns_total's delta), which holds the
per-hop K1/K2 launches, their syncs and the distance fetch."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_program_counters").ms_per_query(
        w, "dgraph_shortest_bfs_ns_total")
