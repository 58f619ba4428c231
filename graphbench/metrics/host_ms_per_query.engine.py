"""Host time of the engine and value layer, ms a request."""

from graphbench import spec

MODULES = ("query/engine.py", "query/task.py", "query/outputnode.py",
           "ops/uidset.py", "storage/index.py")


def read(w):
    return spec.plugin("metrics", "_host_layer").ms_per_query(w, MODULES)
