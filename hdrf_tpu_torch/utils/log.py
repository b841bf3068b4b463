"""Structured logging for the daemons (port of
hdrf_tpu/utils/log.py, whole).

Equivalent of the reference's log4j usage (``LOG.info`` in DataNode.java:499,
DataDeduplicator.java and every daemon main): leveled, named loggers with a
machine-parseable option.  Two output formats, selected by env:

- ``HDRF_LOG_FORMAT=text`` (default): ``ts LEVEL name: event k=v ...``
- ``HDRF_LOG_FORMAT=json``: one JSON object per line (log-shipper friendly)

``HDRF_LOG_LEVEL`` picks the threshold (debug|info|warning|error, default
info).  Loggers default to stderr so daemon stdout stays a clean
operator/handshake channel — startup banners that tooling greps (the
``listening on host:port`` contract ``spawn_local_worker`` parses) pass
``stream=sys.stdout`` explicitly and keep that substring in BOTH formats.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, TextIO

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}
_lock = threading.Lock()


def _threshold() -> int:
    return _LEVELS.get(os.environ.get("HDRF_LOG_LEVEL", "info").lower(), 20)


class Logger:
    __slots__ = ("name", "_stream")

    def __init__(self, name: str, stream: TextIO | None = None) -> None:
        self.name = name
        self._stream = stream

    def _emit(self, level: str, event: str, fields: dict[str, Any]) -> None:
        if _LEVELS[level] < _threshold():
            return
        stream = self._stream if self._stream is not None else sys.stderr
        if os.environ.get("HDRF_LOG_FORMAT", "text").lower() == "json":
            line = json.dumps({"ts": round(time.time(), 3), "level": level,
                               "name": self.name, "event": event, **fields})
        else:
            kv = "".join(f" {k}={v}" for k, v in fields.items())
            line = (f"{time.strftime('%Y-%m-%dT%H:%M:%S')} {level.upper()} "
                    f"{self.name}: {event}{kv}")
        with _lock:
            print(line, file=stream, flush=True)

    def debug(self, event: str, **fields: Any) -> None:
        self._emit("debug", event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit("info", event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit("warning", event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit("error", event, fields)


def get_logger(name: str, stream: TextIO | None = None) -> Logger:
    return Logger(name, stream)
