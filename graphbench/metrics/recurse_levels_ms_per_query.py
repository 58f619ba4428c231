"""The fused @recurse path's device levels, ms a request: the
`recurse_levels` span's time (dgraph_recurse_levels_ns_total's delta),
which holds every level's K1/K2 launches, the per-level popcount reads and
the one fetch of the packed level masks."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_program_counters").ms_per_query(
        w, "dgraph_recurse_levels_ns_total")
