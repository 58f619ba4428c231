"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (device="cpu", tiny sizes) and a fault
is planted in the Node's query call, once for each fault a cell can have.
A cell on one chip has no exchange between chips to leave out."""

import json
import re
import time

import pytest

from graphbench import run

from conftest import CELLS, tiny_cell


def altered(node, call, schema):
    """An answer altered where it is produced: every third answer gets a
    value or a count changed."""
    seen = [0]

    def bad(text):
        out = call(text)
        seen[0] += 1
        if seen[0] % 3:
            return out
        s = json.dumps(out)
        t = re.sub(r'"count": (\d+)', lambda m: f'"count": {int(m[1]) + 1}',
                   s, count=1)
        if t == s:
            t = re.sub(r'"uid": "0x([0-9a-f]+)"',
                       lambda m: f'"uid": "{hex(int(m[1], 16) + 1)}"', s,
                       count=1)
        return json.loads(t)

    return bad


def half_batch(node, call, schema):
    """Half of the batch left out: a request's seed list is cut to its
    first half before the query runs; a request with one start uid has the
    second half of its longest list of rows, or of its count, left out."""

    def cut(m):
        uids = m[1].split(", ")
        return "uid(%s)" % ", ".join(uids[: len(uids) // 2])

    def bad(text):
        m = re.search(r"uid\((0x[^)]*)\)", text)
        if m and ", " in m[1]:
            return call(re.sub(r"uid\((0x[^)]*)\)", cut, text, count=1))
        out = call(text)
        rows = [v for v in _lists(out) if len(v) > 1]
        if rows:
            longest = max(rows, key=len)
            del longest[(len(longest) + 1) // 2:]
        elif "count" in json.dumps(out):
            out = json.loads(re.sub(
                r'"count": (\d+)', lambda m: f'"count": {int(m[1]) // 2}',
                json.dumps(out)))
        return out

    return bad


def _lists(obj):
    if isinstance(obj, list):
        yield obj
        for x in obj:
            yield from _lists(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _lists(x)


def unchanged_state(node, call, schema):
    """A step that returns its state unchanged: every query is served from
    a Node whose store never took the load."""
    from dgraph_tpu_torch.api.server import Node

    empty = Node(device="cpu")
    empty.alter(schema)

    def bad(text):
        return empty.query(text, edge_limit=1 << 31)[0]

    return bad


def lost(node, call, schema):
    """An answer that never comes: every fourth request fails."""
    n = [0]

    def bad(text):
        n[0] += 1
        if n[0] % 4 == 0:
            raise RuntimeError("dropped")
        return call(text)

    return bad


FAULTS = {"altered": altered, "half_batch": half_batch,
          "unchanged_state": unchanged_state, "lost": lost}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    hook = FAULTS[fault]
    cell = tiny_cell(name)
    warm = [0]
    n_warm = len(cell.traffic["requests"]) * cell.traffic["warmup"]

    def planted(node, call):
        bad = hook(node, call, cell.config["schema"])

        def maybe(text):
            # the fault acts in the window, after the warm-up requests
            warm[0] += 1
            return call(text) if warm[0] <= n_warm else bad(text)

        return maybe

    out = run.run_cell(cell, 2**31 + 7, 4.0, False, "cpu",
                       call_hook=planted, t_start=time.perf_counter())
    assert out["correct"] is False
    key = "missing_answers" if fault == "lost" else "wrong_answers"
    assert out["checks"][key]["value"] > 0
