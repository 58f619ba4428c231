"""Prometheus text exposition of a metrics.Registry.

Copy of dgraph_tpu/obs/prom.py for the PyTorch port.

Mapping:
  Counter       -> `counter` when the name ends in _total, else `gauge`
                   (the registry uses Counter.set for gauge-shaped values
                   like dgraph_memory_bytes, matching the reference's
                   expvar dual use).
  Histogram     -> a real `histogram`: cumulative `{le="..."}` buckets
                   over the FIXED exponential bounds plus _sum/_count —
                   aggregatable across nodes and time, unlike the old
                   quantile-label summary rows (never on /metrics; the
                   ring percentiles stay on /debug/metrics).
                   Buckets carry OpenMetrics trace EXEMPLARS
                   (`# {trace_id="..."} value ts`) sampling the trace
                   that landed in each bucket — resolvable at
                   /debug/traces/<id>.
  Meter         -> gauge `dgraph_endpoint_qps{endpoint="<name>"}`.
  KeyedGauge    -> gauge with a `key` label per entry.

Names already follow the dgraph_* vocabulary and are valid Prometheus
metric names; keys/labels are escaped per the text-format rules.
"""

from __future__ import annotations

import re

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# registry names that END in _total but are inc/dec LEVELS, not monotonic
# counters (the reference's expvar dual-use) — a counter TYPE would make
# every decrease read as a reset, so rate()/increase() would spike
_LEVEL_TOTALS = frozenset({"dgraph_pending_queries_total",
                           "dgraph_active_mutations_total"})


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _num(v) -> str:
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def _safe(name: str) -> str:
    return name if _NAME_OK.match(name) else \
        re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _render_histogram(name: str, ex: dict,
                      exemplars_on: bool = True) -> list[str]:
    """Cumulative le-bucket exposition of one exported histogram, with
    OpenMetrics exemplars on the bucket that sampled a trace (suppressed
    for classic text-format scrapes — see render())."""
    out = [f"# TYPE {name} histogram"]
    bounds = ex.get("bounds", [])
    counts = ex.get("counts", [])
    exemplars = ex.get("exemplars", []) if exemplars_on else []
    cum = 0
    for i, le in enumerate(bounds):
        cum += counts[i] if i < len(counts) else 0
        line = f'{name}_bucket{{le="{_num(le)}"}} {cum}'
        e = exemplars[i] if i < len(exemplars) else None
        if e:
            line += (f' # {{trace_id="{_esc(str(e[0]))}"}} '
                     f"{_num(e[1])} {_num(round(float(e[2]), 3))}")
        out.append(line)
    total = int(ex.get("count", 0))
    line = f'{name}_bucket{{le="+Inf"}} {total}'
    e = exemplars[len(bounds)] if len(exemplars) > len(bounds) else None
    if e:
        line += (f' # {{trace_id="{_esc(str(e[0]))}"}} '
                 f"{_num(e[1])} {_num(round(float(e[2]), 3))}")
    out.append(line)
    out.append(f"{name}_sum {_num(ex.get('sum', 0.0))}")
    out.append(f"{name}_count {total}")
    return out


# content types for the two exposition flavors. Exemplar syntax is ONLY
# legal under OpenMetrics: a classic text-format (0.0.4) parser treats
# the trailing '# {...}' as a malformed timestamp and real Prometheus
# would discard the WHOLE scrape — so the HTTP surfaces negotiate on the
# Accept header (wants_openmetrics) and render() only emits exemplars
# when asked.
CONTENT_TYPE_TEXT = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def wants_openmetrics(accept: str | None) -> bool:
    return bool(accept) and "application/openmetrics-text" in accept


def negotiated(accept: str | None, render_fn) -> tuple[bytes, str]:
    """(body, content_type) for one scrape, negotiated on the Accept
    header — the ONE implementation both /metrics (api/http.py) and
    Zero's /metrics/fleet share, so the OM suffix/content-type rules
    cannot drift apart. render_fn(exemplars: bool) -> str."""
    om = wants_openmetrics(accept)
    text = render_fn(om)
    if om:
        text += "# EOF\n"
    return text.encode(), (CONTENT_TYPE_OPENMETRICS if om
                           else CONTENT_TYPE_TEXT)


def render(registry, exemplars: bool = False) -> str:
    """The /metrics payload. The registry's metric MAPS are copied under
    its lock (a concurrent first-use setdefault must not resize them
    mid-iteration); the per-metric reads below use each metric's own
    locking."""
    lock = getattr(registry, "_lock", None)
    if lock is not None:
        with lock:
            counters = dict(registry.counters)
            histograms = dict(registry.histograms)
            meters = dict(registry.meters)
            keyed = dict(registry.keyed_gauges)
    else:
        counters, histograms = dict(registry.counters), \
            dict(registry.histograms)
        meters, keyed = dict(registry.meters), dict(registry.keyed_gauges)
    out: list[str] = []

    for name, c in sorted(counters.items()):
        name = _safe(name)
        kind = "counter" if name.endswith("_total") \
            and name not in _LEVEL_TOTALS else "gauge"
        out.append(f"# TYPE {name} {kind}")
        out.append(f"{name} {_num(c.value)}")

    for name, h in sorted(histograms.items()):
        name = _safe(name)
        out.extend(_render_histogram(name, h.export(),
                                     exemplars_on=exemplars))

    if meters:
        out.append("# TYPE dgraph_endpoint_qps gauge")
        for name, m in sorted(meters.items()):
            out.append(f'dgraph_endpoint_qps{{endpoint="{_esc(name)}"}} '
                       f"{_num(m.rate())}")

    for name, g in sorted(keyed.items()):
        name = _safe(name)
        out.append(f"# TYPE {name} gauge")
        labels = getattr(g, "labels", None)
        for key, v in sorted(g.snapshot().items()):
            if labels:
                parts = key.split("|", len(labels) - 1)
                if len(parts) == len(labels):
                    lbl = ",".join(f'{n}="{_esc(p)}"'
                                   for n, p in zip(labels, parts))
                    out.append(f"{name}{{{lbl}}} {_num(v)}")
                    continue
            out.append(f'{name}{{key="{_esc(key)}"}} {_num(v)}')

    return "\n".join(out) + "\n"


def render_export(export: dict, exemplars: bool = False) -> str:
    """Prometheus text exposition of a Registry.export() snapshot — the
    merged-fleet payload Zero serves at /metrics/fleet. Counter/gauge
    typing follows the same name rules as render(); histograms render
    their merged buckets (exact across nodes: fixed bounds)."""
    out: list[str] = []
    for name, v in sorted(export.get("counters", {}).items()):
        name = _safe(name)
        kind = "counter" if name.endswith("_total") \
            and name not in _LEVEL_TOTALS else "gauge"
        out.append(f"# TYPE {name} {kind}")
        out.append(f"{name} {_num(v)}")
    for name, h in sorted(export.get("histograms", {}).items()):
        out.extend(_render_histogram(_safe(name), h,
                                     exemplars_on=exemplars))
    for name, g in sorted(export.get("keyed", {}).items()):
        name = _safe(name)
        out.append(f"# TYPE {name} gauge")
        labels = g.get("labels")
        for key, v in sorted(g.get("vals", {}).items()):
            if labels:
                parts = key.split("|", len(labels) - 1)
                if len(parts) == len(labels):
                    lbl = ",".join(f'{n}="{_esc(p)}"'
                                   for n, p in zip(labels, parts))
                    out.append(f"{name}{{{lbl}}} {_num(v)}")
                    continue
            out.append(f'{name}{{key="{_esc(key)}"}} {_num(v)}')
    return "\n".join(out) + "\n"


# an exemplar suffix on a bucket sample (OpenMetrics):
#   # {trace_id="..."} value [timestamp]
_EXEMPLAR_RE = re.compile(
    r"\s+#\s+\{([^}]*)\}\s+(\S+)(?:\s+(\S+))?$")


def parse(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Minimal text-format parse check: returns {metric: [(labels, value)]}
    and raises ValueError on any malformed line. Bucket samples may carry
    OpenMetrics exemplars — parsed off and exposed as an `__exemplar__`
    pseudo-label so tests can round-trip a trace id. Used by tests and
    contrib/scripts smoke checks — not a full Prometheus client."""
    series: dict[str, list[tuple[dict, float]]] = {}
    typed: dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                if not _NAME_OK.match(parts[2]):
                    raise ValueError(f"line {ln}: bad metric name {parts[2]}")
                if parts[3] not in ("counter", "gauge", "summary",
                                    "histogram", "untyped"):
                    raise ValueError(f"line {ln}: bad type {parts[3]}")
                typed[parts[2]] = parts[3]
            continue
        exemplar = None
        em = _EXEMPLAR_RE.search(line)
        if em is not None:
            ex_labels: dict[str, str] = {}
            for item in re.finditer(
                    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
                    em.group(1)):
                ex_labels[item.group(1)] = item.group(2)
            try:
                float(em.group(2))
            except ValueError:
                raise ValueError(
                    f"line {ln}: non-numeric exemplar value {em.group(2)!r}")
            exemplar = ex_labels
            line = line[: em.start()]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                     r"(?:\{([^}]*)\})?\s+(\S+)$", line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name, labels_raw, value = m.groups()
        labels: dict[str, str] = {}
        if labels_raw:
            for item in re.finditer(
                    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
                    labels_raw):
                labels[item.group(1)] = item.group(2)
            if not labels:
                raise ValueError(f"line {ln}: malformed labels {labels_raw!r}")
        try:
            fv = float(value)
        except ValueError:
            raise ValueError(f"line {ln}: non-numeric value {value!r}")
        base = re.sub(r"_(sum|count|bucket)$", "", name)
        if base not in typed and name not in typed:
            raise ValueError(f"line {ln}: sample {name} without # TYPE")
        if exemplar is not None:
            labels = dict(labels)
            labels["__exemplar__"] = exemplar.get("trace_id", "")
        series.setdefault(name, []).append((labels, fv))
    return series
