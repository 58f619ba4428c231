"""Bytes the program's device seams copied from the card to the host, a
request: dgraph_transfer_d2h_bytes_total's delta."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_span_counters").per_query(
        w, "dgraph_transfer_d2h_bytes_total")
