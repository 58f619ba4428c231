"""Threshold-gated slow-query log.

Copy of dgraph_tpu/obs/slowlog.py for the PyTorch port.

A query whose root span exceeds `threshold_ms` records an entry carrying
the query text, elapsed time, the assembled span tree (with per-span
cardinality/cache/device attrs), and — when the planner ran — the plan
summary with estimated cardinalities. Entries live in a bounded ring
(`/debug/slow`) and optionally append to a JSONL file for offline
digestion (one JSON object per line; rotation is the operator's job).

The ring is also the landing zone for COST REGRESSIONS: the
cost ledger flags a query whose device cost exceeds k x its plan-shape's
EWMA baseline via record() directly — bypassing the threshold gate on
purpose, because a 2ms shape regressing to 40ms never crosses a 500ms
--slow_query_ms. Those entries carry root="cost_regression" plus
device_ms/baseline_ms/factor (obs/costs.CostBook).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from dgraph_tpu_torch.obs import otrace


class SlowQueryLog:
    def __init__(self, threshold_ms: float = 0.0, keep: int = 64,
                 path: str | None = None) -> None:
        """threshold_ms <= 0 disables the log entirely."""
        self.threshold_ms = float(threshold_ms)
        self._ring: deque[dict] = deque(maxlen=keep)
        self._lock = threading.Lock()
        self._path = path
        self._file = None
        self.dropped_writes = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_ms > 0

    def observe(self, root: dict, spans: list[dict]) -> None:
        """Tracer assembly hook: called with every completed local trace."""
        if not self.enabled or root["dur"] * 1e3 < self.threshold_ms:
            return
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
            "trace_id": root["trace_id"],
            "root": root["name"],
            "elapsed_ms": round(root["dur"] * 1e3, 3),
            "error": root.get("error", ""),
            "query": root.get("attrs", {}).get("query", ""),
            "plan": root.get("attrs", {}).get("plan"),
            "spans": len(spans),
            "tree": otrace.span_tree(
                {"trace_id": root["trace_id"], "spans": spans})["tree"],
        }
        self.record(entry)

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.appendleft(entry)
            if self._path is not None:
                try:
                    if self._file is None:
                        self._file = open(self._path, "a")
                    self._file.write(
                        json.dumps(entry, default=str,
                                   separators=(",", ":")) + "\n")
                    self._file.flush()
                except OSError:
                    # a full/yanked disk must never fail the query path
                    self.dropped_writes += 1

    def recent(self, n: int = 32) -> list[dict]:
        with self._lock:
            return [e for i, e in enumerate(self._ring) if i < n]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
