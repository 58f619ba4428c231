"""Structured logging: one process-wide sink, text or JSON lines.

Copy of dgraph_tpu/utils/log.py for the PyTorch port. The serve banners
("serving HTTP on host:port") keep their text: tests and scripts parse the
bound port out of it.

Reference: the reference logs through glog; this port previously used 21
bare print() call sites in the CLI. get_logger() gives each component a
named logger; --log_json (or configure(json_mode=True)) switches every
line to single-line JSON ({"ts","level","component","event",...fields}),
the shape log shippers ingest without a parse rule. Text mode keeps the
human-readable "<event> key=value" form on stderr-free stdout, flushed
per line (the CLI's print(..., flush=True) contract)."""

from __future__ import annotations

import json
import sys
import threading
import time

_lock = threading.Lock()
_json_mode = False
_stream = None          # None = sys.stdout at call time (testable)


def configure(json_mode: bool = False, stream=None) -> None:
    """Install process-wide output mode (the --log_json flag's target)."""
    global _json_mode, _stream
    _json_mode = bool(json_mode)
    _stream = stream


def json_mode() -> bool:
    return _json_mode


class Logger:
    __slots__ = ("component",)

    def __init__(self, component: str) -> None:
        self.component = component

    def _emit(self, level: str, event: str, fields: dict) -> None:
        out = _stream if _stream is not None else sys.stdout
        if _json_mode:
            rec = {"ts": round(time.time(), 3), "level": level,
                   "component": self.component, "event": event}
            rec.update(fields)
            line = json.dumps(rec, default=str, separators=(",", ":"))
        else:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            line = f"{event} {kv}" if kv else event
        with _lock:
            try:
                out.write(line + "\n")
                out.flush()
            except (ValueError, OSError):
                pass     # closed stream at shutdown: logging never raises

    def info(self, event: str, **fields) -> None:
        self._emit("info", event, fields)

    def warn(self, event: str, **fields) -> None:
        self._emit("warn", event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit("error", event, fields)


def get_logger(component: str) -> Logger:
    return Logger(component)
