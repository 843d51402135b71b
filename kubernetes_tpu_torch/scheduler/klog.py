"""Structured + contextual logging — the klog v2 analog.

reference: k8s.io/klog/v2 as adopted through component-base/logs: call sites
write `logger.V(4).info("Scheduled pod", pod=..., node=...)` — a message plus
key-value pairs, never format strings — and the backend renders text
(`"msg" k=v k=v`) or JSON (component-base/logs/json).  Contextual logging:
`logger.with_values(pod=...)` returns a child whose pairs prefix every entry
(klog.LoggerWithValues).

Verbosity: entries at V(n) emit only when n <= the configured verbosity
(klog's -v flag).  The default sink appends to an in-memory ring (tests,
parity debugging); `to_stderr()`/`to_json_stderr()` stream instead.

Trace-log correlation: an entry emitted inside an active tracing span
(scheduler/tracing.py — the contextvar current span) carries that span's
trace_id/span_id as trailing key-value pairs, the way the reference's
otelhttp-instrumented handlers stamp log lines — so one pod's log entries
join up with its span tree.

The port's copy of the JAX package's ``scheduler/klog.py``.
"""

from __future__ import annotations

import json
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Optional, Tuple

from .tracing import current_span
from ..analysis.lockcheck import make_lock


@dataclass(frozen=True)
class Entry:
    ts: float
    level: int  # verbosity the entry was emitted at (0 = always)
    severity: str  # INFO | ERROR
    msg: str
    kv: Tuple[Tuple[str, object], ...]

    def text(self) -> str:
        pairs = " ".join(f"{k}={v!r}" for k, v in self.kv)
        return f'{self.severity[0]} "{self.msg}"' + (f" {pairs}" if pairs else "")

    def json(self) -> str:
        return json.dumps(
            {"ts": self.ts, "v": self.level, "severity": self.severity,
             "msg": self.msg, **dict(self.kv)},
            default=str,
        )


class Logger:
    """The shared backend + a context prefix (LoggerWithValues chain)."""

    def __init__(
        self,
        verbosity: int = 2,
        sink: Optional[Callable[[Entry], None]] = None,
        _parent: Optional["Logger"] = None,
        _ctx: Tuple[Tuple[str, object], ...] = (),
    ):
        if _parent is not None:
            self._root = _parent._root
        else:
            self._root = self
            self.verbosity = verbosity
            self.ring: Deque[Entry] = deque(maxlen=10_000)
            self._sink = sink
            self._lock = make_lock("Logger._lock")
        self._ctx = _ctx

    # -- klog surface --
    def V(self, level: int) -> "_Leveled":
        return _Leveled(self, level)

    def info(self, msg: str, **kv) -> None:
        self._emit(0, "INFO", msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._emit(0, "ERROR", msg, kv)

    def with_values(self, **kv) -> "Logger":
        """Contextual child: these pairs prefix every entry it emits."""
        return Logger(_parent=self, _ctx=self._ctx + tuple(kv.items()))

    # -- wiring --
    def _emit(self, level: int, severity: str, msg: str, kv: Dict) -> None:
        root = self._root
        if level > root.verbosity:
            return
        pairs = self._ctx + tuple(kv.items())
        sp = current_span()
        if sp is not None:
            pairs += (("trace_id", sp.trace_id), ("span_id", sp.span_id))
        e = Entry(time.time(), level, severity, msg, pairs)
        with root._lock:
            root.ring.append(e)
            if root._sink is not None:
                root._sink(e)

    def entries(self, msg: Optional[str] = None) -> list:
        root = self._root
        with root._lock:
            out = list(root.ring)
        return [e for e in out if msg is None or e.msg == msg]

    def to_stderr(self) -> "Logger":
        self._root._sink = lambda e: print(e.text(), file=sys.stderr)
        return self

    def to_json_stderr(self) -> "Logger":
        """component-base/logs/json — the structured JSON backend."""
        self._root._sink = lambda e: print(e.json(), file=sys.stderr)
        return self


class _Leveled:
    def __init__(self, logger: Logger, level: int):
        self._logger = logger
        self._level = level

    @property
    def enabled(self) -> bool:  # klog V(n).Enabled()
        return self._level <= self._logger._root.verbosity

    def info(self, msg: str, **kv) -> None:
        self._logger._emit(self._level, "INFO", msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._logger._emit(self._level, "ERROR", msg, kv)
