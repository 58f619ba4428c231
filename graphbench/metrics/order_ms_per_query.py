"""A root's ordering, ms a request: the `order` span's time
(dgraph_order_ns_total's delta), the sort of the root's uids by their
order keys (a val() key over a grouped var: the columns' top first +
offset)."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_program_counters").ms_per_query(
        w, "dgraph_order_ns_total")
