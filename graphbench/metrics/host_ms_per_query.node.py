"""Host time of the serving Node, ms a request."""

from graphbench import spec

MODULES = ("api/server.py", "query/dql.py", "query/qcache.py",
           "query/planner.py", "obs/")


def read(w):
    return spec.plugin("metrics", "_host_layer").ms_per_query(w, MODULES)
