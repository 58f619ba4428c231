"""Device-side substrate of the port, under the JAX package's names.

uidset:   sorted-uid set algebra (reference: algo/uidlist.go)
csr:      CSR frontier expansion / SpMSpV gather (reference: posting list
          iteration, worker/task.go handleUidPostings)
segments: segmented reductions for @groupby / aggregation
          (reference: query/groupby.go, query/aggregator.go)

Importing this package imports torch: host-only processes (the bulk
loader's parse workers) import no module of it.
"""

from dgraph_tpu_torch.ops.uidset import (  # noqa: F401
    SENTINEL32,
    SENTINEL64,
    sentinel,
    make_set,
    to_numpy,
    size,
    compact,
    intersect,
    merge,
    difference,
    is_member,
    apply_filter,
    index_of,
    intersect_many,
    merge_many,
    paginate,
)
from dgraph_tpu_torch.ops.csr import (  # noqa: F401
    expand,
    expand_dest,
    degrees,
)
from dgraph_tpu_torch.ops.segments import (  # noqa: F401
    group_reduce,
    segment_reduce,
)
