"""Subject and degree views of an adjacency.

Port of csr_subjects_host and csr_subjects_degrees from
dgraph_tpu/storage/delta.py, for a plain PredCSR (the delta overlay waits
for the storage slice). has(~pred) reads the subjects of the reverse
adjacency; eq(count(pred), n) compares out-degrees.
"""

from __future__ import annotations

import numpy as np


def csr_subjects_host(csr) -> np.ndarray:
    """Host-side subject uids of a PredCSR (int64)."""
    return np.asarray(csr.host_arrays()[0], dtype=np.int64)


def csr_subjects_degrees(csr) -> tuple[np.ndarray, np.ndarray]:
    """(subjects, out-degrees) of a PredCSR — the count-index base quantity."""
    s, ip, _ = csr.host_arrays()
    ip = np.asarray(ip, dtype=np.int64)
    return np.asarray(s, dtype=np.int64), ip[1:] - ip[:-1]
