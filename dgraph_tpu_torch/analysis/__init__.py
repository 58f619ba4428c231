"""dgraph-analyze for the port: project-invariant static analysis.

An AST-walking checker framework encoding the invariants the serving code
must keep — metric pre-registration, contextvar discipline across thread
seams, deadline discipline at blocking waits, the seam error taxonomy,
trace-time purity of captured torch code, the fault-point registry
cross-check, and static lock-order extraction (the compile-time sibling
of utils/locks.py lockdep). The rules mirror the JAX package's analyzer;
`jax-purity` becomes `capture-purity`, which knows torch's capture sites.

Run it:

    python -m dgraph_tpu_torch.analysis                 # the port package
    python -m dgraph_tpu_torch.analysis --rule deadline-wait path/to/file.py
    python -m dgraph_tpu_torch.analysis --format=json dgraph_tpu_torch/

Suppress a finding where the flagged code is deliberate:

    pool.submit(self._loop)   # dgraph: allow(ctxvar-copy) detached bg loop

(the comment goes on the flagged line or the line directly above; the
rationale after the closing paren is free text, but write one). The
analyzer runs as a tier-1 test over the whole port package
(tests/test_torch_analysis.py) and must come up clean — the README's
"Project invariants (port)" section documents every rule.

Like every checker, this package imports no torch, numpy or grpc, and
nothing of the JAX package.
"""

from .core import Finding, SourceFile
from .runner import RULES, analyze_paths

__all__ = ["Finding", "SourceFile", "RULES", "analyze_paths"]
