"""Fault injection for tests (port of hdrf_tpu/utils/fault_injection.py,
unchanged: ``point`` and its install/remove/clear/inject API).

Equivalent of the reference's injectable singletons (DataNodeFaultInjector.java:33,
BlockManagerFaultInjector, CheckpointFaultInjector, ...): main code declares named
points via :func:`point`; tests install handlers that raise/delay/count at precise
moments. Zero overhead when no handler is installed.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

_handlers: dict[str, Callable[..., Any]] = {}
_lock = threading.Lock()


def point(name: str, **kw: Any) -> None:
    """Declare an injection point. Called from main code at precise moments,
    e.g. ``fault_injection.point("replica.finalize", block_id=bid)``."""
    h = _handlers.get(name)
    if h is not None:
        h(**kw)


def install(name: str, handler: Callable[..., Any]) -> None:
    with _lock:
        _handlers[name] = handler


def remove(name: str) -> None:
    with _lock:
        _handlers.pop(name, None)


def clear() -> None:
    with _lock:
        _handlers.clear()


class inject:
    """Context manager: ``with inject("dn.heartbeat", lambda **kw: 1/0): ...``"""

    def __init__(self, name: str, handler: Callable[..., Any]) -> None:
        self.name, self.handler = name, handler

    def __enter__(self) -> "inject":
        install(self.name, self.handler)
        return self

    def __exit__(self, *exc: Any) -> None:
        remove(self.name)
