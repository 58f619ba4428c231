"""Live queries: standing subscriptions re-derived O(Δ) per commit window.

Port of dgraph_tpu/live/."""

from .diff import canon, result_diff
from .manager import LiveManager, Subscription

__all__ = ["LiveManager", "Subscription", "canon", "result_diff"]
