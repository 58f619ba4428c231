"""coord/placement of the port against the JAX package's, on the CPU.

The decision core (tablet_score, utilization, plan_action, diff_rates) gets
tests/test_placement.py's cases in both packages and must return the same
scores, spreads, actions and diagnostics; the PlacementController, over
each package's Zero with a scripted load report and a fake clock, must take
the same actions tick by tick and journal the same decisions. The Node's
TabletLoadBook counts reads at the task seam and writes at mutate: after
the same request sequence, a port Node's /debug/metrics `tablet_load` and
/metrics `dgraph_tablet_load{pred,group,stat}` equal the JAX Node's, with
the serve-time stat (a clock reading) left out. Exact throughout.
"""

import json

import pytest
import torch

from dgraph_tpu.coord import placement as jpl
from dgraph_tpu.coord.zero import Zero as JZero

from dgraph_tpu_torch.coord import placement as tpl
from dgraph_tpu_torch.coord.zero import Zero as TZero

PKGS = (jpl, tpl)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rates(mod, **groups):
    out = {}
    for g, tablets in groups.items():
        out[int(g[1:])] = {a: mod.TabletRate(reads=r, writes=w)
                           for a, (r, w) in tablets.items()}
    return out


def _sizes(rates, size=1 << 20):
    return {g: {a: size for a in t} for g, t in rates.items()}


def _act(a):
    return None if a is None else (a.kind, a.attr, a.src, a.dst, a.reason)


@pytest.mark.parametrize("size,rate", [(0, 0.0), (1 << 10, 100.0),
                                       (1 << 30, 100.0), (1 << 30, 0.0),
                                       (12345, 3.5)])
def test_tablet_score_equals_jax(size, rate):
    assert tpl.tablet_score(size, rate) == jpl.tablet_score(size, rate)


def test_residency_scores_with_the_placement_rule():
    from dgraph_tpu_torch.storage import residency as tres

    assert tres.tablet_score is tpl.tablet_score


PLANS = {
    "balanced": (dict(g0={"a": (10, 0)}, g1={"b": (10, 0)}),
                 {"a": 0, "b": 1}, {}, {}, None),
    "idle": (dict(g0={"a": (0, 0)}, g1={"b": (0, 0)}),
             {"a": 0, "b": 1}, {}, {}, None),
    "below_threshold": (dict(g0={"a": (12, 0)}, g1={"b": (10, 0)},
                             g2={"c": (9, 0)}),
                        {"a": 0, "b": 1, "c": 2}, {}, {}, None),
    "skew_read_heavy": (dict(g0={"hot": (90, 1)}, g1={"b": (9, 0)},
                             g2={"c": (3, 0)}),
                        {"hot": 0, "b": 1, "c": 2}, {}, {}, None),
    "multi_tablet": (dict(g0={"a": (20, 0), "b": (18, 0), "c": (16, 0)},
                          g1={"d": (5, 0)}, g2={"e": (5, 0)}),
                     {"a": 0, "b": 0, "c": 0, "d": 1, "e": 2}, {}, {}, None),
    "write_hot": (dict(g0={"hot": (10, 50)}, g1={"b": (3, 0)},
                       g2={"c": (3, 0)}),
                  {"hot": 0, "b": 1, "c": 2}, {}, {}, None),
    "max_replicas": (dict(g0={"hot": (90, 0)}, g1={"b": (5, 0)},
                          g2={"c": (5, 0)}),
                     {"hot": 0, "b": 1, "c": 2}, {"hot": {2: 10}},
                     {"max_replicas": 1}, None),
    "holders": (dict(g0={"hot": (90, 0)}, g1={"b": (5, 0)},
                     g2={"c": (5, 0)}),
                {"hot": 0, "b": 1, "c": 2}, {"hot": {1: 10, 2: 10}},
                {"max_replicas": 4}, None),
    "demote_cold": (dict(g0={"hot": (0.0, 0)}, g1={"b": (0.0, 0)},
                         g2={"c": (0, 0)}),
                    {"hot": 0, "b": 1, "c": 2}, {"hot": {2: 10}}, {}, None),
    "blocked": (dict(g0={"hot": (90, 0)}, g1={"b": (5, 0)},
                     g2={"c": (5, 0)}),
                {"hot": 0, "b": 1, "c": 2}, {}, {}, {"hot"}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_action_equals_jax(case):
    groups, tablets, replicas, cfg, blocked = PLANS[case]
    outs = []
    for mod in PKGS:
        r = _rates(mod, **groups)
        kw = {"blocked": blocked} if blocked is not None else {}
        act, diag = mod.plan_action(_sizes(r), r, tablets, replicas,
                                    mod.PlacementConfig(**cfg), **kw)
        spread, per_group, _ = mod.utilization(_sizes(r), r)
        outs.append((_act(act), json.dumps(diag, sort_keys=True,
                                           default=str),
                     spread, per_group))
    assert outs[0] == outs[1]


def test_plan_actions_as_the_reference_tests_want():
    r = _rates(tpl, g0={"hot": (90, 1)}, g1={"b": (9, 0)}, g2={"c": (3, 0)})
    act, diag = tpl.plan_action(_sizes(r), r, {"hot": 0, "b": 1, "c": 2},
                                {}, tpl.PlacementConfig())
    assert (act.kind, act.attr, act.dst) == ("add_replica", "hot", 2)
    assert diag["spread"] > 0.35


@pytest.mark.parametrize("prev,cur,dt", [
    ({"a": {"r": 100.0, "w": 10.0}}, {"a": {"r": 5.0, "w": 1.0}}, 1.0),
    ({"a": {"r": 10.0}}, {"a": {"r": 30.0}}, 2.0),
    ({}, {"a": {"r": 3.0, "w": 2.0, "b": 64.0, "d": 0.5}}, 0.5),
], ids=["restart", "rate", "new"])
def test_diff_rates_equals_jax(prev, cur, dt):
    j = jpl.diff_rates(prev, cur, dt)
    t = tpl.diff_rates(prev, cur, dt)
    assert {a: vars(v) for a, v in t.items()} == \
        {a: vars(v) for a, v in j.items()}


def test_tablet_load_book_equals_jax():
    from dgraph_tpu.obs import prom as jprom
    from dgraph_tpu.utils.metrics import Registry as JReg
    from dgraph_tpu_torch.obs import prom as tprom
    from dgraph_tpu_torch.utils.metrics import Registry as TReg

    regs = (JReg(), TReg())
    books = (jpl.TabletLoadBook(regs[0], group=3),
             tpl.TabletLoadBook(regs[1], group=3))
    for b in books:
        b.record_read("name", out_bytes=64.0, serve_s=0.002)
        b.record_read("name")
        b.record_read("~follows", out_bytes=8.0, serve_s=0.0105)
        b.record_write("name", n=3)
        b.record_write("age")
    assert books[1].snapshot() == books[0].snapshot()
    texts = (jprom.render(regs[0]), tprom.render(regs[1]))
    assert [ln for ln in texts[1].splitlines() if "tablet_load" in ln] == \
        [ln for ln in texts[0].splitlines() if "tablet_load" in ln]
    assert tpl.TabletLoadBook().snapshot() == {}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _controller(mod, zero_cls, loads):
    """A controller over a 3-group Zero whose load report replays `loads`
    (one cumulative report per tick) and whose executor records calls."""
    zero = zero_cls(n_groups=3)
    for attr, g in (("hot", 0), ("b", 1), ("c", 2)):
        zero.should_serve(attr)
        zero.move_tablet(attr, g)
    calls = []
    state = {"i": 0}

    def collect():
        cur = loads[min(state["i"], len(loads) - 1)]
        return {g: ({a: 1 << 20 for a in cur[g]}, cur[g]) for g in cur}

    class Exec:
        def move(self, attr, dst):
            calls.append(("move", attr, dst))
            zero.move_tablet(attr, dst)

        def add_replica(self, attr, dst):
            calls.append(("add_replica", attr, dst))
            zero.add_replica(attr, dst, 1)

        def drop_replica(self, attr, group):
            calls.append(("drop_replica", attr, group))
            zero.drop_replica(attr, group)

    clock = _Clock()
    ctl = mod.PlacementController(
        zero, collect, Exec(), mod.PlacementConfig(persist_ticks=2,
                                                   cooldown_s=5.0),
        clock=clock)
    return ctl, clock, state, calls


def test_controller_ticks_equal_jax():
    """Hysteresis, replication of a skew-dominant read-heavy tablet,
    cooldown and the decision journal, tick by tick."""
    loads = []
    cum = {0: {"hot": {"r": 0.0, "w": 0.0}}, 1: {"b": {"r": 0.0, "w": 0.0}},
           2: {"c": {"r": 0.0, "w": 0.0}}}
    for _ in range(8):
        cum = {0: {"hot": {"r": cum[0]["hot"]["r"] + 90.0, "w": 1.0}},
               1: {"b": {"r": cum[1]["b"]["r"] + 9.0, "w": 0.0}},
               2: {"c": {"r": cum[2]["c"]["r"] + 3.0, "w": 0.0}}}
        loads.append(cum)
    runs = []
    for mod, zcls in ((jpl, JZero), (tpl, TZero)):
        ctl, clock, state, calls = _controller(mod, zcls, loads)
        acts = []
        for i in range(len(loads)):
            state["i"] = i
            acts.append(_act(ctl.tick()))
            clock.t += 1.0
        dec = [{k: v for k, v in d.items() if k not in ("ts", "at")}
               for d in ctl.decisions()]
        runs.append((acts, calls, json.dumps(dec, sort_keys=True,
                                             default=str)))
    assert runs[1] == runs[0]
    assert ("add_replica", "hot", 2) in runs[1][1]


# ---------------------------------------------------------------------------
# the Node's load book on /debug/metrics and /metrics
# ---------------------------------------------------------------------------

SCHEMA = """
    name: string @index(exact) .
    age: int @index(int) .
    follows: [uid] @reverse .
"""


def _strip_serve(sect):
    return {a: {k: v for k, v in row.items() if k != "d"}
            for a, row in sect.items()}


def _series(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("dgraph_tablet_load{")
                  and 'stat="serve_ms"' not in line)


def test_node_tablet_load_equals_jax():
    from dgraph_tpu.api.http import _serving_metrics as jserving
    from dgraph_tpu.api.server import Node as JNode
    from dgraph_tpu.obs import prom as jprom
    from dgraph_tpu_torch.api.http import _serving_metrics as tserving
    from dgraph_tpu_torch.api.server import Node as TNode
    from dgraph_tpu_torch.obs import prom as tprom

    kw = dict(planner=False, batching=False, devprof=False)
    j, t = JNode(**kw), TNode(device="cpu", **kw)
    try:
        for n in (j, t):
            n.alter(schema_text=SCHEMA)
            n.mutate(set_nquads='_:a <name> "x" .\n_:a <age> "30"^^<xs:int> .'
                                '\n_:b <name> "y" .\n_:a <follows> _:b .',
                     commit_now=True)
            for _ in range(3):
                n.query('{ q(func: eq(name, "x")) { name age '
                        'follows { name } ~follows { uid } } }')
        js, ts = jserving(j)["tablet_load"], tserving(t)["tablet_load"]
        assert ts["name"]["r"] >= 1 and ts["name"]["w"] >= 1
        assert {"r", "w", "b", "d"} <= set(ts["name"])
        assert _strip_serve(ts) == _strip_serve(js)
        tt, jt = tprom.render(t.metrics), jprom.render(j.metrics)
        assert _series(tt) == _series(jt) and _series(tt)
        series = tprom.parse(tt)
        by = {(ls["pred"], ls["stat"]): v
              for ls, v in series["dgraph_tablet_load"]}
        assert by[("name", "reads")] >= 1 and by[("name", "bytes")] >= 1
    finally:
        j.close()
        t.close()
