"""Shared by the K1/K2 roofline readers: the least time the H100 could
take for the window's launches of one active-prefix kernel, over the time
the device trace gives that kernel in the window, in %.

The bound is PERF.md's: each launch reads its edge stream's int32 source
ranks and writes an int32 prefix per edge slot (8 B a slot, padding
included), and reads its frontier structure once (K1 the bitmap's words,
K2 the search table's entries, 4 B each); the design computes 22 (K1) or
19 (K2) integer operations an edge slot. A launch's bound is the larger of
its bytes over HBM's 3.35 TB/s and its operations over 16.7e12 integer
operations a second (132 SMs x 64 INT32 lanes x 1.98 GHz). At 8 B against
22 operations a slot the bytes bound every launch, so the sums over the
window's launches give the sum of the launches' bounds.

What a launch streamed comes from the program's Node-registry counters
(dgraph_prefix_k{1,2}_*_total, booked by ops/prefix.py). A program whose
registry lacks them gives no reading; so does a window in which the trace
holds no time for the kernel.
"""

from graphbench import spec

PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 16.7e12

KERNELS = {
    # reader key: (device-trace kernel name, frontier counter, ops a slot)
    "k1": ("dense_scan", "dgraph_prefix_k1_bitmap_words_total", 22),
    "k2": ("sparse_scan", "dgraph_prefix_k2_table_entries_total", 19),
}


def bound_s(k: str, slots: int, frontier_words: int) -> float:
    """The least time for launches that streamed `slots` edge slots and
    `frontier_words` words of frontier structure in all."""
    _, _, ops = KERNELS[k]
    nbytes = 8 * slots + 4 * frontier_words
    return max(nbytes / PEAK_BYTES_S, ops * slots / PEAK_INT_OPS_S)


def share(w, k: str):
    name, words, _ = KERNELS[k]
    slots = f"dgraph_prefix_{k}_edge_slots_total"
    registered = spec.plugin("metrics", "_program_counters").registered
    if not (registered(slots) and registered(words)):
        return None
    device_s = sum(d for n, _, d in w.device_events if name in n)
    if device_s <= 0:
        return None
    return 100.0 * bound_s(k, w.counters.get(slots, 0),
                           w.counters.get(words, 0)) / device_s
