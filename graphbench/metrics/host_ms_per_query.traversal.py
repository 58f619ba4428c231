"""Host time of the traversal layer, ms a request."""

from graphbench import spec

MODULES = ("query/recurse.py", "query/shortest.py", "ops/pull_bfs.py",
           "ops/prefix.py", "ops/traversal.py", "ops/csr.py")


def read(w):
    return spec.plugin("metrics", "_host_layer").ms_per_query(w, MODULES)
