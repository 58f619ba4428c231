"""The shortest-path cell at a tiny size on the CPU: its own faults come
out not correct, and its reference is sound.

The faults are planted in the Node's query call after the warm-up, as in
test_graphbench_faults.py: a longer path (a detour out of the source and
back, with its weight), a tie broken to another uid than the minimum (the
answers of the port's Bellman-Ford tier, which takes the maximum-uid
predecessor), a path dropped as if the target were out of reach, and a
`_weight_` one too high. This module also gives conftest.TINY the new
configuration's tiny scale, which the cell-wide tests read when they run.
"""

import json
import time

import pytest

from graphbench import run, spec
from graphbench.reference import paths
from graphbench.reference.dataset import Reference

from conftest import TINY

CELL = "g500u20.shortest-pair"
TINY.setdefault("graph500-undirected-s20", {"scale": 10})


def _first_neighbour(call, uid: str) -> str:
    out = call("{ q(func: uid(%s)) { friend { uid } } }" % uid)
    return out["q"][0]["friend"][0]["uid"]


def longer(node, call):
    def bad(text):
        out = call(text)
        if "_path_" not in out:
            return out
        head = out["_path_"][0]
        n = _first_neighbour(call, head["uid"])
        rest = {k: v for k, v in head.items() if k != "_weight_"}
        detour = {"uid": head["uid"], "friend": [{"uid": n, "friend": [rest]}]}
        detour["_weight_"] = head["_weight_"] + 2
        return {"_path_": [detour]}

    return bad


def other_tie(node, call):
    from dgraph_tpu_torch.query import shortest

    def bad(text):
        old = shortest.DEVICE_SSSP_MIN_EDGES, shortest.SSSP_KERNEL_MIN
        shortest.DEVICE_SSSP_MIN_EDGES, shortest.SSSP_KERNEL_MIN = 0, None
        try:
            return call(text)
        finally:
            shortest.DEVICE_SSSP_MIN_EDGES, shortest.SSSP_KERNEL_MIN = old

    return bad


def dropped(node, call):
    return lambda text: {}


def weight(node, call):
    def bad(text):
        out = call(text)
        if "_path_" in out:
            out["_path_"][0]["_weight_"] += 1
        return out

    return bad


FAULTS = {"longer": longer, "other_tie": other_tie, "dropped": dropped,
          "weight": weight}


def tiny():
    cell = spec.cell(CELL)
    cell.config.update(TINY[cell.config["name"]])
    return cell


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    cell = tiny()
    warm = [0]
    n_warm = cell.traffic["warmup"]

    def planted(node, call):
        node.result_cache = node.task_cache = None
        bad = FAULTS[fault](node, call)

        def maybe(text):
            warm[0] += 1
            return call(text) if warm[0] <= n_warm else bad(text)

        return maybe

    out = run.run_cell(cell, 2**31 + 7, 4.0, False, "cpu",
                       call_hook=planted, t_start=time.perf_counter())
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] > 0
    assert out["checks"]["missing_answers"]["value"] == 0


def test_the_reference_answer_is_dgraphs_shape():
    """The reference's answer for a path has Dgraph's `_path_` nesting,
    and none for a target out of reach."""
    kind = spec.plugin("requests", "shortest_pair")
    assert kind.render([5, 9, 2], "friend") == {"_path_": [{
        "uid": "0x5", "friend": [{"uid": "0x9", "friend": [{"uid": "0x2"}]}],
        "_weight_": 2.0}]}
    assert kind.render(None, "friend") == {}
    cell = tiny()
    data = run.host_data(spec.plugin("datagen", cell.config["generator"])
                         .generate(cell.config, 5, "cpu"))
    ref = Reference(data)
    src, dst = (int(x) for x in data["pools"]["friend"][:2])
    path = paths.shortest_path(ref.adj["friend"], src, dst, kind.DEPTH)
    req = {"src": src, "dst": dst, "pred": "friend"}
    assert json.dumps(kind.answer(ref, req)[0]) == json.dumps(
        kind.render(path, "friend"))
