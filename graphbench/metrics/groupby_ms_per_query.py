"""A level's @groupby, ms a request: the `groupby` span's time
(dgraph_groupby_ns_total's delta), which holds the member expand, the
grouping (on the card where the targets stay there) and the binding of
the grouped vars."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_program_counters").ms_per_query(
        w, "dgraph_groupby_ns_total")
