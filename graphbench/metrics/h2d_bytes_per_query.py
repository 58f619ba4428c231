"""Bytes the program's device seams copied from the host to the card, a
request: dgraph_transfer_h2d_bytes_total's delta."""

from graphbench import spec


def read(w):
    return spec.plugin("metrics", "_span_counters").per_query(
        w, "dgraph_transfer_h2d_bytes_total")
