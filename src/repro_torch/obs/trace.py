"""Span/event tracing in Chrome-trace (Perfetto-loadable) JSON (a copy of
``repro.obs.trace`` with a ``torch.profiler`` pass-through).

``Tracer`` collects Trace Event Format records — complete spans
(``"ph": "X"`` with ``ts``/``dur``) and instant events (``"ph": "i"``) —
and ``save()``s them as ``{"traceEvents": [...]}``, the JSON object form
chrome://tracing and ui.perfetto.dev both load.  Timestamps are
microseconds on a per-tracer monotonic epoch (``time.perf_counter``).

Spans come in two forms:

  * ``with tracer.span("prefill", args={"rid": 3}):`` — measures the
    enclosed block.  The span name is passed through to
    ``torch.profiler.record_function`` too, so the same annotation shows up
    in a ``torch.profiler`` trace when one is being captured.
  * ``tracer.complete(name, start_s, dur_s)`` — retroactive span from
    host-side timestamps already on hand (e.g. a request's queue-wait
    window emitted at retire time).

``NullTracer`` is the disabled twin: every method is a no-op and ``span``
is a reusable null context manager, so instrumented code needs no
``if tracing:`` guards.  The module-global tracer (``get_tracer``)
defaults to the null tracer; launchers swap in a real one for
``--trace-out``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch

__all__ = ["Tracer", "NullTracer", "get_tracer", "set_tracer"]


class Tracer:
    """Chrome-trace event collector.  Thread-safe appends; ``tid`` selects
    the lane (default: per-thread ident, or pass one explicitly to group
    logical tracks such as request slots)."""

    def __init__(self, *, process_name: str = "repro", pid: int = 0):
        self.pid = pid
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        # Metadata record naming the process lane in the Perfetto UI.
        self.events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": process_name},
            }
        )

    # -- clock -------------------------------------------------------------

    def now_s(self) -> float:
        """Seconds on this tracer's epoch (pair with ``complete``)."""
        return time.perf_counter() - self._epoch

    def _us(self, t_s: float) -> float:
        return t_s * 1e6

    # -- emission ----------------------------------------------------------

    def _append(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "", tid: Optional[int] = None,
             args: Optional[dict] = None):
        """Measure the enclosed block as a complete ("X") event."""
        tid = threading.get_ident() % 2**31 if tid is None else tid
        t0 = self.now_s()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            self.complete(name, t0, self.now_s() - t0, cat=cat, tid=tid,
                          args=args)

    def complete(self, name: str, start_s: float, dur_s: float, *,
                 cat: str = "", tid: int = 0,
                 args: Optional[dict] = None) -> None:
        """Retroactive span from host timestamps on this tracer's epoch."""
        ev = {
            "name": name,
            "cat": cat or "repro",
            "ph": "X",
            "ts": self._us(start_s),
            "dur": max(self._us(dur_s), 0.0),
            "pid": self.pid,
            "tid": tid,
        }
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def complete_abs(self, name: str, start_perf: float, end_perf: float, *,
                     cat: str = "", tid: int = 0,
                     args: Optional[dict] = None) -> None:
        """Retroactive span from raw ``time.perf_counter()`` timestamps
        (instrumented code keeps perf_counter values; this converts onto
        the tracer epoch)."""
        self.complete(name, start_perf - self._epoch, end_perf - start_perf,
                      cat=cat, tid=tid, args=args)

    def instant(self, name: str, *, cat: str = "", tid: int = 0,
                args: Optional[dict] = None) -> None:
        ev = {
            "name": name,
            "cat": cat or "repro",
            "ph": "i",
            "s": "t",  # scope: thread
            "ts": self._us(self.now_s()),
            "pid": self.pid,
            "tid": tid,
        }
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def thread_name(self, tid: int, name: str) -> None:
        """Label a lane (e.g. ``slot 3``) in the Perfetto track list."""
        self._append(
            {"ph": "M", "name": "thread_name", "pid": self.pid, "tid": tid,
             "args": {"name": name}}
        )

    # -- export ------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


class NullTracer:
    """Disabled tracer: structurally API-compatible, allocation-free."""

    events: tuple = ()

    @contextlib.contextmanager
    def span(self, name, *, cat="", tid=None, args=None):
        yield self

    def now_s(self) -> float:
        return 0.0

    def complete(self, *a, **k) -> None:
        pass

    def complete_abs(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def thread_name(self, *a, **k) -> None:
        pass

    def to_dict(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:  # pragma: no cover - debugging aid
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


NULL_TRACER = NullTracer()
_current = NULL_TRACER


def get_tracer():
    """The ambient tracer (``NullTracer`` unless a launcher installed one)."""
    return _current


def set_tracer(tracer) -> None:
    global _current
    _current = tracer if tracer is not None else NULL_TRACER
