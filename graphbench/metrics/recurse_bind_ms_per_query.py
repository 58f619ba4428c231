"""The @recurse var binding, ms a request: the `recurse_bind` span's time
(dgraph_recurse_bind_ns_total's delta), the union of every level's dest
uids that a var on the recurse's predicate binds."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_program_counters").ms_per_query(
        w, "dgraph_recurse_bind_ns_total")
