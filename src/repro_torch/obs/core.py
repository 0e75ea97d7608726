"""The telemetry runtime: structured events, spans, and the no-op contract
(copy of ``repro.obs.core``).

A single process-wide collector (:class:`Telemetry`) is either installed or
not.  Every module-level helper (``span``/``event``/``count``/``gauge``/
``observe``) reads one global and returns immediately when it is ``None`` —
the disabled path allocates nothing beyond the kwargs dict of the call
itself, which is why instrumentation may sit on per-solve and per-chunk
host paths (never per-iteration device paths; those are traced code and
off-limits by the host-side-only rule, docs/DESIGN.md §12).

Event records are plain dicts, one of:

    {"ev": "span",  "name", "id", "parent", "ts", "dur_s", "attrs": {...}}
    {"ev": "event", "name", "ts", "attrs": {...}}

``ts`` is seconds since the collector was enabled (monotonic clock); spans
are recorded at *close*, children before parents, so an ordered replay can
rebuild the tree from ``id``/``parent`` alone (``repro_torch.obs.report`` does).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

_ACTIVE: Optional["Telemetry"] = None


class Span:
    """One timed, attributed region; records an event when it exits."""

    __slots__ = ("_tel", "name", "attrs", "id", "parent", "_t0")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self.id = 0
        self.parent = 0
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes after entry (e.g. a resolved
        backend name known only mid-span)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tel = self._tel
        self.id = next(tel._ids)
        stack = tel._stack_of()
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tel = self._tel
        dur = time.perf_counter() - self._t0
        stack = tel._stack_of()
        if stack and stack[-1] == self.id:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        tel.events.append({
            "ev": "span", "name": self.name, "id": self.id,
            "parent": self.parent,
            "ts": round(self._t0 - tel._t0, 6), "dur_s": round(dur, 6),
            "attrs": self.attrs})
        return False


class _NoopSpan:
    """Shared do-nothing span returned by every helper while disabled."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class Telemetry:
    """One run's collector: ordered event list + metrics registry."""

    def __init__(self, meta: Optional[dict] = None):
        self._t0 = time.perf_counter()
        self.wall_start = time.time()
        self.meta = dict(meta or {})
        self.events: List[dict] = []
        self.metrics = MetricsRegistry()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack_of(self) -> List[int]:
        stack = getattr(self._local, "spans", None)
        if stack is None:
            stack = self._local.spans = []
        return stack

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        self.events.append({"ev": "event", "name": name,
                            "ts": round(self.now(), 6), "attrs": attrs})


# ---------------------------------------------------------------------------
# module-level API — the only thing instrumentation call sites touch
# ---------------------------------------------------------------------------


def get() -> Optional[Telemetry]:
    """The active collector, or None when telemetry is disabled."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def enable(meta: Optional[dict] = None) -> Telemetry:
    """Install (and return) a fresh process-wide collector."""
    global _ACTIVE
    _ACTIVE = Telemetry(meta)
    return _ACTIVE


def disable() -> Optional[Telemetry]:
    """Uninstall the collector; returns it for export/inspection."""
    global _ACTIVE
    tel, _ACTIVE = _ACTIVE, None
    return tel


@contextlib.contextmanager
def session(jsonl_path: Optional[str] = None,
            meta: Optional[dict] = None) -> Iterator[Telemetry]:
    """Scoped telemetry: enabled inside the block, restored after.

    ``jsonl_path`` writes the JSONL event log on exit (also on error — a
    crashed run still leaves its trace).  The previously active collector,
    if any, is reinstalled afterwards, so sessions nest safely.
    """
    global _ACTIVE
    prev = _ACTIVE
    tel = Telemetry(meta)
    _ACTIVE = tel
    try:
        yield tel
    finally:
        _ACTIVE = prev
        if jsonl_path is not None:
            from repro_torch.obs.exporters import write_jsonl
            write_jsonl(tel, jsonl_path)


def span(name: str, **attrs):
    """A context-manager span, or the shared no-op when disabled."""
    tel = _ACTIVE
    return tel.span(name, **attrs) if tel is not None else _NOOP_SPAN


def event(name: str, **attrs) -> None:
    tel = _ACTIVE
    if tel is not None:
        tel.event(name, **attrs)


def count(name: str, n: int = 1, **labels) -> None:
    tel = _ACTIVE
    if tel is not None:
        tel.metrics.counter(name, **labels).inc(n)


def gauge(name: str, value: float, **labels) -> None:
    tel = _ACTIVE
    if tel is not None:
        tel.metrics.gauge(name, **labels).set(value)


def observe(name: str, value: float, **labels) -> None:
    tel = _ACTIVE
    if tel is not None:
        tel.metrics.histogram(name, **labels).observe(value)
