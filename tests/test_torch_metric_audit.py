"""The port's runtime /metrics audit, against
tests/test_costs.py::test_every_incremented_metric_is_preregistered.

Every dgraph_* name constructed anywhere in dgraph_tpu_torch/ must appear
on a FRESH port Node's /metrics. The source walk is the port analyzer's
metric-registration collector (dgraph_tpu_torch/analysis — one
implementation, two consumers: this runtime audit and the
`python -m dgraph_tpu_torch.analysis` tier-1 gate).
"""

import threading
import urllib.request
from pathlib import Path

from dgraph_tpu_torch.analysis.checkers import collect_metric_names
from dgraph_tpu_torch.api.http import make_server
from dgraph_tpu_torch.api.server import Node
from dgraph_tpu_torch.obs import costs, prom


def test_every_incremented_metric_is_preregistered():
    pkg = Path(costs.__file__).resolve().parent.parent
    names = collect_metric_names(pkg)
    assert len(names) > 80, f"audit scan looks broken: {len(names)} names"
    assert "dgraph_kernel_launches" in names
    n = Node(device="cpu")
    try:
        text = prom.render(n.metrics)
        series = prom.parse(text)
        missing = []
        for name in sorted(names):
            present = (name in series or f"{name}_count" in series
                       or f"# TYPE {name} " in text)
            if not present:
                missing.append(name)
        assert not missing, \
            f"metrics incremented somewhere but absent from a fresh " \
            f"node's /metrics: {missing} — pre-register them in " \
            f"utils/metrics.Registry"
    finally:
        n.close()


def test_kernel_launches_scrape_fills_the_preregistered_series(monkeypatch):
    # the scrape copies ops/prefix.py's LAUNCHES into the series the
    # Registry declared, with the `kernel` label, never a second series
    # (the plain versions the CPU runs count nothing, so counts are set)
    from dgraph_tpu_torch.ops import prefix

    monkeypatch.setitem(prefix.LAUNCHES, "active_prefix", 3)
    monkeypatch.setitem(prefix.LAUNCHES, "active_prefix_sparse", 0)
    n = Node(device="cpu")
    declared = n.metrics.keyed_gauges["dgraph_kernel_launches"]
    assert declared.labels == ("kernel",)
    srv = make_server(n, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            text = r.read().decode()
        assert "# TYPE dgraph_kernel_launches gauge" in text
        assert n.metrics.keyed_gauges["dgraph_kernel_launches"] is declared
        got = {ls["kernel"]: v for ls, v in
               prom.parse(text).get("dgraph_kernel_launches", [])}
        assert got == {"active_prefix": 3}
    finally:
        srv.shutdown()
        srv.server_close()
        n.close()
