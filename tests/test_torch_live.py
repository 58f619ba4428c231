"""Live queries in the PyTorch port (dgraph_tpu_torch/live/), on the CPU.

The cases of tests/test_live.py against the port's Node(device="cpu"):
lifecycle, O(Δ) wake filtering, per-window coalescing, flow control,
journal retention, the `live` endpoint of the cost ledger, the SSE surface
of the port's HTTP server, and the byte-identity gate — every
notification's result must be byte-identical (live.diff.canon) to
re-running the query read-only at the commit watermark it carries. The
multi-group cluster case waits for the mesh slice.

Then across packages, one commit at a time (how commits coalesce into
windows depends on timing, so windows are not compared): the same
subscription on a JAX Node and on a port Node yields events of the same
types at equal watermarks, each result equal to canon of a read-only query
at its watermark on both sides. Every SSE read has a timeout.
"""

import json
import threading
import time

import numpy as np
import pytest

from dgraph_tpu.api.server import Node as JNode
from dgraph_tpu.live import diff as jdiff

from dgraph_tpu_torch.api.server import Node as TNode
from dgraph_tpu_torch.live.diff import canon, result_diff


def Node(**kw):
    return TNode(device="cpu", **kw)

SCHEMA = """
name: string @index(term) .
age: int @index(int) .
follows: [uid] @reverse .
"""

Q_NAME = "{ q(func: has(name)) { uid name } }"


@pytest.fixture
def node():
    n = Node()
    n.alter(SCHEMA)
    n.mutate(set_nquads='<0x1> <name> "alice" .\n<0x2> <name> "bob" .\n'
                        '<0x1> <age> "30" .',
             commit_now=True)
    yield n
    n.close()


def _assert_byte_identical(node, q, ev):
    """THE correctness gate: the notification's result re-derives exactly
    at its carried watermark."""
    rerun = node.query(q, start_ts=ev["at"], read_only=True)[0]
    assert canon(ev["result"]) == canon(rerun), (ev, rerun)


# -- diff engine -------------------------------------------------------------

def test_result_diff_uid_keyed():
    old = {"q": [{"uid": "0x1", "name": "a"}, {"uid": "0x2", "name": "b"}]}
    new = {"q": [{"uid": "0x1", "name": "a2"}, {"uid": "0x3", "name": "c"}]}
    d = result_diff(old, new)
    assert d["q"]["changed"] == [{"uid": "0x1", "name": "a2"}]
    assert d["q"]["added"] == [{"uid": "0x3", "name": "c"}]
    assert d["q"]["removed"] == [{"uid": "0x2", "name": "b"}]


def test_result_diff_uidless_multiset_and_no_change():
    old = {"q": [{"count": 2}]}
    assert result_diff(old, {"q": [{"count": 3}]})["q"]["added"] == [
        {"count": 3}]
    assert result_diff(old, {"q": [{"count": 2}]}) is None
    assert result_diff(None, {"q": []}) is None


def test_canon_is_order_insensitive_and_compact():
    assert canon({"b": 1, "a": [1, 2]}) == '{"a":[1,2],"b":1}'
    assert canon({"a": 1, "b": 2}) == canon({"b": 2, "a": 1})


# -- lifecycle ---------------------------------------------------------------

def test_subscribe_init_diff_cancel(node):
    sub = node.subscribe(Q_NAME)
    ev = sub.next(5)
    assert ev["type"] == "init" and ev["sub"] == sub.id
    assert {e["name"] for e in ev["result"]["q"]} == {"alice", "bob"}
    _assert_byte_identical(node, Q_NAME, ev)

    node.mutate(set_nquads='<0x3> <name> "carol" .', commit_now=True)
    ev = sub.next(5)
    assert ev["type"] == "diff"
    assert ev["diff"]["q"]["added"] == [{"uid": "0x3", "name": "carol"}]
    assert ev["diff"]["q"]["removed"] == []
    _assert_byte_identical(node, Q_NAME, ev)

    # delete reports as removed
    node.mutate(del_nquads='<0x3> <name> * .', commit_now=True)
    ev = sub.next(5)
    assert ev["type"] == "diff"
    assert ev["diff"]["q"]["removed"] == [{"uid": "0x3", "name": "carol"}]
    _assert_byte_identical(node, Q_NAME, ev)

    assert sub.cancel() is True
    assert sub.cancel() is False
    with pytest.raises(StopIteration):
        sub.next(1)
    assert node.live.stats()["active"] == 0


def test_subscription_is_an_iterator(node):
    sub = node.subscribe(Q_NAME)
    it = iter(sub)
    assert next(it)["type"] == "init"
    node.mutate(set_nquads='<0x4> <name> "dave" .', commit_now=True)
    assert next(it)["type"] == "diff"
    sub.cancel()


def test_mutations_not_subscribable(node):
    with pytest.raises(Exception):
        node.subscribe('{ set { <0x1> <name> "x" . } }')
    with pytest.raises(Exception):
        node.subscribe("schema {}")
    assert node.live.stats()["active"] == 0


def test_watermark_monotone_and_carried(node):
    sub = node.subscribe(Q_NAME)
    last = sub.next(5)["at"]
    for i in range(3):
        node.mutate(set_nquads=f'<0x{i + 5:x}> <name> "u{i}" .',
                    commit_now=True)
        ev = sub.next(5)
        assert ev["at"] > last
        last = ev["at"]
        _assert_byte_identical(node, Q_NAME, ev)
    sub.cancel()


# -- O(Δ) wake filtering -----------------------------------------------------

def test_unrelated_predicate_does_not_wake(node):
    sub = node.subscribe(Q_NAME)
    sub.next(5)
    evals0 = node.metrics.counter("dgraph_subs_evals_total").value
    node.mutate(set_nquads='<0x1> <age> "31" .', commit_now=True)
    assert sub.next(0.8) is None   # commit touched only `age`
    # ... and the notifier never re-evaluated anything for it
    assert node.metrics.counter("dgraph_subs_evals_total").value == evals0
    node.mutate(set_nquads='<0x9> <name> "eve" .', commit_now=True)
    ev = sub.next(5)
    assert ev["type"] == "diff"
    _assert_byte_identical(node, Q_NAME, ev)
    sub.cancel()


def test_touch_test_covers_filters_and_children(node):
    q = ('{ q(func: has(name)) @filter(ge(age, 0)) '
         '{ uid name follows { uid name } } }')
    sub = node.subscribe(q)
    sub.next(5)
    # a commit touching only a FILTER predicate must wake it
    node.mutate(set_nquads='<0x2> <age> "44" .', commit_now=True)
    ev = sub.next(5)
    assert ev is not None and ev["type"] == "diff", ev
    _assert_byte_identical(node, q, ev)
    # ... and a child predicate too
    node.mutate(set_nquads="<0x1> <follows> <0x2> .", commit_now=True)
    ev = sub.next(5)
    assert ev is not None and ev["type"] == "diff", ev
    _assert_byte_identical(node, q, ev)
    sub.cancel()


def test_wildcard_plan_wakes_on_every_commit(node):
    # explicit uids => plan_attrs None => wake on every window
    q = "{ q(func: uid(0x1)) { uid name age } }"
    sub = node.subscribe(q)
    sub.next(5)
    assert node.live.stats()["wildcard"] == 1
    node.mutate(set_nquads='<0x1> <age> "32" .', commit_now=True)
    ev = sub.next(5)
    assert ev is not None and ev["type"] == "diff"
    _assert_byte_identical(node, q, ev)
    sub.cancel()


def test_false_positive_wake_advances_cursor_silently(node):
    # touches `name` (the subscribed attr) on a uid the query result
    # doesn't change for: must wake + re-eval but deliver NOTHING
    q = '{ q(func: eq(name, "alice")) { uid name } }'
    sub = node.subscribe(q)
    w0 = sub.next(5)["at"]
    node.mutate(set_nquads='<0x2> <name> "bobby" .', commit_now=True)
    assert sub.next(0.8) is None
    assert sub.cursor > w0     # cursor advanced without a notification
    sub.cancel()


# -- coalescing --------------------------------------------------------------

def test_identical_subscriptions_coalesce_to_one_eval(node):
    subs = [node.subscribe(Q_NAME) for _ in range(8)]
    for s in subs:
        s.next(5)
    evals0 = node.metrics.counter("dgraph_subs_evals_total").value
    wakes0 = node.metrics.counter("dgraph_subs_wakeups_total").value
    node.mutate(set_nquads='<0xa> <name> "zed" .', commit_now=True)
    evs = [s.next(5) for s in subs]
    assert all(e["type"] == "diff" for e in evs)
    # all 8 notifications came from the same watermark + payload
    assert len({e["at"] for e in evs}) == 1
    assert len({canon(e["result"]) for e in evs}) == 1
    d_evals = node.metrics.counter("dgraph_subs_evals_total").value - evals0
    d_wakes = node.metrics.counter("dgraph_subs_wakeups_total").value - wakes0
    assert d_wakes == 8 and d_evals == 1, (d_wakes, d_evals)
    for s in subs:
        s.cancel()


def test_commit_burst_coalesces_into_windows(node):
    sub = node.subscribe(Q_NAME)
    sub.next(5)
    # burst of commits while the notifier evaluates: deliveries may
    # coalesce into fewer windows, but the LAST delivery must reflect
    # everything, byte-identically at its watermark
    for i in range(6):
        node.mutate(set_nquads=f'<0x{i + 16:x}> <name> "b{i}" .',
                    commit_now=True)
    final = None
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        ev = sub.next(0.6)
        if ev is not None:
            final = ev
        n = len(final["result"]["q"]) if final else 0
        if n == 2 + 6:
            break
    assert final is not None
    assert len(final["result"]["q"]) == 8
    _assert_byte_identical(node, Q_NAME, final)
    sub.cancel()


# -- reconnect cursors -------------------------------------------------------

def test_cursor_ack_when_journal_proves_unchanged(node):
    sub = node.subscribe(Q_NAME)
    w = sub.next(5)["at"]
    sub.cancel()
    sub2 = node.subscribe(Q_NAME, cursor=w)
    ev = sub2.next(5)
    assert ev["type"] == "ack" and "result" not in ev
    assert ev["at"] >= w
    sub2.cancel()


def test_stale_cursor_resyncs(node):
    sub = node.subscribe(Q_NAME)
    w = sub.next(5)["at"]
    sub.cancel()
    node.mutate(set_nquads='<0xb> <name> "newguy" .', commit_now=True)
    sub2 = node.subscribe(Q_NAME, cursor=w)
    ev = sub2.next(5)
    assert ev["type"] == "resync" and ev["reason"] == "cursor"
    _assert_byte_identical(node, Q_NAME, ev)
    sub2.cancel()


def test_wildcard_cursor_can_never_ack(node):
    q = "{ q(func: uid(0x1)) { uid name } }"
    sub = node.subscribe(q)
    w = sub.next(5)["at"]
    sub.cancel()
    # nothing changed, but a wildcard read set is unprovable => resync
    sub2 = node.subscribe(q, cursor=w)
    assert sub2.next(5)["type"] == "resync"
    sub2.cancel()


# -- flow control ------------------------------------------------------------

def test_slow_consumer_sheds_to_typed_resync(node):
    sub = node.subscribe(Q_NAME, queue_max=1)
    sub.next(5)
    for i in range(4):     # consumer never drains between windows
        node.mutate(set_nquads=f'<0x{i + 32:x}> <name> "s{i}" .',
                    commit_now=True)
        time.sleep(0.05)
    deadline = time.monotonic() + 10
    ev = None
    while time.monotonic() < deadline:
        nxt = sub.next(0.5)
        if nxt is None and ev is not None and \
                len(ev["result"]["q"]) == 2 + 4:
            break
        if nxt is not None:
            ev = nxt
    # the queue was replaced, never grown: a resync was delivered at some
    # point and the final state converged byte-identically
    assert node.metrics.counter("dgraph_subs_sheds_total").value >= 1
    assert ev is not None and len(ev["result"]["q"]) == 6
    _assert_byte_identical(node, Q_NAME, ev)
    assert len(sub.queue) <= 1
    sub.cancel()


def test_blocked_subscription_expires():
    n = Node(live_idle_timeout_s=0.2)
    try:
        n.alter(SCHEMA)
        n.mutate(set_nquads='<0x1> <name> "alice" .', commit_now=True)
        sub = n.subscribe(Q_NAME, queue_max=1)
        # never consume: init sits in the queue, the next delivery sheds
        # (marking the queue blocked), and the expiry sweep reaps it
        n.mutate(set_nquads='<0x2> <name> "bob" .', commit_now=True)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not sub.closed:
            time.sleep(0.1)
        assert sub.closed
        assert n.metrics.counter("dgraph_subs_expired_total").value == 1
        # the final queued event is the typed expire marker
        evs = []
        try:
            while True:
                evs.append(sub.next(0.1))
        except StopIteration:
            pass
        assert evs and evs[-1]["type"] == "expire"
        assert n.live.stats()["active"] == 0
    finally:
        n.close()


# -- journal retention -------------------------------------------------------

def test_journal_pinned_by_oldest_cursor(node):
    assert node.store.delta_log_stats()["pinned_floor"] is None
    sub = node.subscribe(Q_NAME)
    w = sub.next(5)["at"]
    st = node.store.delta_log_stats()
    assert st["pinned_floor"] is not None and st["pinned_floor"] <= w
    # prune above the pin is clamped: entries stay provable
    node.mutate(set_nquads='<0xc> <name> "pinned" .', commit_now=True)
    ev = sub.next(5)
    node.store.prune_delta("name", ev["at"] + 100)
    assert node.store.delta_since("name", sub.cursor) is not None
    sub.cancel()
    assert node.store.delta_log_stats()["pinned_floor"] is None


def test_journal_knob_and_overflow_resync():
    n = Node(delta_journal_max_keys=4)
    try:
        n.alter(SCHEMA)
        n.mutate(set_nquads='<0x1> <name> "alice" .', commit_now=True)
        assert n.store.delta_log_stats()["max_keys"] == 4
        sub = n.subscribe(Q_NAME)
        sub.next(5)
        # one commit touching >4 distinct keys of `name` overflows the
        # journal => the subscription must receive a typed resync, not a
        # silent gap
        quads = "\n".join(f'<0x{i + 64:x}> <name> "o{i}" .'
                          for i in range(8))
        n.mutate(set_nquads=quads, commit_now=True)
        ev = sub.next(10)
        assert ev is not None and ev["type"] == "resync", ev
        assert ev["reason"] in ("overflow", "shed")
        assert ev["reason"] == "overflow"
        assert len(ev["result"]["q"]) == 1 + 8
        rerun = n.query(Q_NAME, start_ts=ev["at"], read_only=True)[0]
        assert canon(ev["result"]) == canon(rerun)
        assert n.store.delta_log_stats()["overflows"] >= 1
        assert n.metrics.counter(
            "dgraph_delta_journal_overflows").value >= 1
        sub.cancel()
    finally:
        n.close()


# -- cost attribution --------------------------------------------------------

def test_live_evals_rank_under_live_endpoint(node):
    sub = node.subscribe(Q_NAME)
    sub.next(5)
    node.mutate(set_nquads='<0xd> <name> "costed" .', commit_now=True)
    sub.next(5)
    top = node.cost_book.top(window_s=300, group="shape", endpoint="live")
    assert top["endpoint"] == "live"
    assert any(Q_NAME.startswith(r["key"][:20]) for r in top["top"]), top
    # the foreground view excludes standing load
    fg = node.cost_book.top(window_s=300, group="endpoint")
    assert "live" in {r["key"] for r in fg["top"]}
    sub.cancel()


# -- serving-metrics sections ------------------------------------------------

def test_debug_metrics_journal_and_subscriptions_sections(node):
    from dgraph_tpu_torch.api.http import _serving_metrics

    sub = node.subscribe(Q_NAME)
    sub.next(5)
    sm = _serving_metrics(node)
    j = sm["journal"]
    assert {"attrs", "keys", "max_keys", "overflows",
            "pinned_floor"} <= set(j)
    s = sm["subscriptions"]
    assert s["active"] == 1 and s["registered"] == 1
    assert {"notifications", "wakeups", "evals", "sheds", "resyncs",
            "expired", "reaped", "heartbeats",
            "notify_latency_s"} <= set(s)
    sub.cancel()


# -- HTTP SSE surface --------------------------------------------------------

@pytest.fixture
def http_node(node):
    from dgraph_tpu_torch.api.http import make_server

    srv = make_server(node, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield node, srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


def _read_frame(fp):
    """One SSE frame (blank-line terminated) as its list of lines."""
    lines = []
    while True:
        raw = fp.readline()            # the socket's timeout bounds it
        if not raw:
            raise EOFError("the SSE stream closed mid-frame")
        ln = raw.decode("utf-8").rstrip("\n")
        if ln == "":
            if lines:
                return lines
            continue
        lines.append(ln)


def _sse_connect(port, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("POST", "/subscribe", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return conn, resp


def test_http_subscribe_sse_stream(http_node):
    node, port = http_node
    conn, resp = _sse_connect(port, {"query": Q_NAME})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    fr = _read_frame(resp.fp)
    assert fr[0] == "event: init"
    ev = json.loads(fr[1][len("data: "):])
    assert {e["name"] for e in ev["result"]["q"]} == {"alice", "bob"}
    node.mutate(set_nquads='<0x21> <name> "pushed" .', commit_now=True)
    while True:
        fr = _read_frame(resp.fp)
        if not fr[0].startswith(":"):
            break
    assert fr[0] == "event: diff"
    ev = json.loads(fr[1][len("data: "):])
    assert ev["diff"]["q"]["added"] == [{"uid": "0x21", "name": "pushed"}]
    # the wire payload is the canonical encoding — byte-identity holds on
    # exactly what the client received
    rerun = node.query(Q_NAME, start_ts=ev["at"], read_only=True)[0]
    assert canon(ev["result"]) == canon(rerun)
    conn.close()


def test_http_subscribe_heartbeats_and_reap(http_node):
    node, port = http_node
    conn, resp = _sse_connect(port, {"query": Q_NAME, "heartbeat_s": 0.2})
    _read_frame(resp.fp)                     # init
    fr = _read_frame(resp.fp)
    assert fr[0].startswith(": hb"), fr      # comment frame, not an event
    deadline = time.monotonic() + 5          # counter incs after the write
    while time.monotonic() < deadline and not \
            node.metrics.counter("dgraph_subs_heartbeats_total").value:
        time.sleep(0.05)
    assert node.metrics.counter("dgraph_subs_heartbeats_total").value >= 1
    # vanish without cancel (close the response's fd too — it holds a
    # dup of the socket): the next failed write must REAP the
    # subscription so it cannot pin the journal floor forever
    resp.close()
    conn.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and node.live.stats()["active"]:
        time.sleep(0.1)
    assert node.live.stats()["active"] == 0
    assert node.metrics.counter("dgraph_subs_reaped_total").value == 1
    assert node.store.delta_log_stats()["pinned_floor"] is None


def test_http_subscribe_cursor_roundtrip(http_node):
    node, port = http_node
    conn, resp = _sse_connect(port, {"query": Q_NAME})
    ev = json.loads(_read_frame(resp.fp)[1][len("data: "):])
    conn.close()
    # reconnect at the delivered watermark: ack, no result payload
    conn2, resp2 = _sse_connect(port, {"query": Q_NAME, "cursor": ev["at"]})
    fr = _read_frame(resp2.fp)
    assert fr[0] == "event: ack"
    assert "result" not in json.loads(fr[1][len("data: "):])
    conn2.close()
    # reconnect at a pre-change cursor: typed resync with the full result
    node.mutate(set_nquads='<0x22> <name> "moved" .', commit_now=True)
    conn3, resp3 = _sse_connect(port, {"query": Q_NAME, "cursor": ev["at"]})
    fr = _read_frame(resp3.fp)
    assert fr[0] == "event: resync"
    ev3 = json.loads(fr[1][len("data: "):])
    assert ev3["reason"] == "cursor" and "result" in ev3
    conn3.close()


def test_http_subscribe_invalid_is_enveloped_error(http_node):
    _node, port = http_node
    conn, resp = _sse_connect(port, {"query": "{ q(func: nosuchfn()) }"})
    assert resp.status == 400
    err = json.loads(resp.read())
    assert err["errors"], err
    conn.close()


# -- concurrency hammer ------------------------------------------------------

def test_many_subscribers_concurrent_writes_all_converge(node):
    n_subs = 16
    subs = [node.subscribe(Q_NAME) for _ in range(n_subs)]
    finals = [s.next(5) for s in subs]

    stop = threading.Event()
    errs = []

    def drain(i, s):
        try:
            while not stop.is_set():
                try:
                    ev = s.next(0.2)
                except StopIteration:
                    return
                if ev is not None:
                    finals[i] = ev
        except Exception as e:  # surfaced by the main thread's assert
            errs.append(e)

    threads = [threading.Thread(target=drain, args=(i, s), daemon=True)
               for i, s in enumerate(subs)]
    for t in threads:
        t.start()
    for i in range(10):
        node.mutate(set_nquads=f'<0x{i + 128:x}> <name> "w{i}" .',
                    commit_now=True)
    # wait until every subscriber reflects the final state
    want = 2 + 10
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if all(len(f["result"]["q"]) == want for f in finals):
            break
        time.sleep(0.1)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not errs, errs
    for f in finals:
        assert len(f["result"]["q"]) == want
        _assert_byte_identical(node, Q_NAME, f)
    for s in subs:
        s.cancel()


# -- across packages -----------------------------------------------------------

def _jax_node(**kw):
    return JNode(planner=False, batching=False, devprof=False, **kw)


def test_events_match_the_jax_node_commit_by_commit():
    """A seeded program of commits, one at a time, to a JAX Node and a port
    Node holding the same data: each commit that changes the subscribed
    result delivers one event on each side, of the same type, at the
    commit's timestamp, with equal diffs and results, each result equal to
    canon of a read-only query at that watermark; a commit that touches
    only an unsubscribed predicate delivers nothing on either side."""
    rng = np.random.default_rng(23)
    jn, tn = _jax_node(), Node()
    subs = []
    try:
        for n in (jn, tn):
            n.alter(SCHEMA)
            n.mutate(set_nquads='<0x1> <name> "alice" .\n'
                                '<0x2> <name> "bob" .', commit_now=True)
        subs = [n.subscribe(Q_NAME) for n in (jn, tn)]
        first = [s.next(5) for s in subs]
        assert [e["type"] for e in first] == ["init", "init"]
        assert first[0]["at"] == first[1]["at"]
        assert jdiff.canon(first[0]["result"]) == canon(first[1]["result"])
        named = {1, 2}
        for i in range(12):
            u = int(rng.integers(1, 9))
            kind = rng.choice(["set", "delete", "age"])
            if kind == "delete" and u not in named:
                kind = "set"
            if kind == "set":
                quads, changes = f'<{hex(u)}> <name> "n{i}" .', True
                named.add(u)
            elif kind == "age":
                quads, changes = f'<{hex(u)}> <age> "{i}" .', False
            else:
                quads, changes = f"<{hex(u)}> <name> * .", True
                named.discard(u)
            ts = []
            for n in (jn, tn):
                if kind == "delete":
                    res = n.mutate(del_nquads=quads, commit_now=True)
                else:
                    res = n.mutate(set_nquads=quads, commit_now=True)
                ts.append(res.context.commit_ts)
            assert ts[0] == ts[1]
            if not changes:
                assert [s.next(0.5) for s in subs] == [None, None], i
                continue
            evs = [s.next(5) for s in subs]
            assert all(e is not None for e in evs), (i, evs)
            assert evs[0]["type"] == evs[1]["type"] == "diff", evs
            assert evs[0]["at"] == evs[1]["at"] == ts[0]
            assert jdiff.canon(evs[0]["diff"]) == canon(evs[1]["diff"])
            assert jdiff.canon(evs[0]["result"]) == canon(evs[1]["result"])
            for n, ev in zip((jn, tn), evs):
                rerun = n.query(Q_NAME, start_ts=ev["at"], read_only=True)[0]
                assert canon(ev["result"]) == canon(rerun)
    finally:
        for s in subs:
            s.cancel()
        jn.close()
        tn.close()
