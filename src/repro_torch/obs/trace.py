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

``span(..., device=True)`` times the block on the device's clock: on the
card a pair of CUDA events on the current stream brackets the work the
block enqueues.  ``flush()`` places each completed pair on the tracer's
epoch through an anchor event it records, waits for and reads the host
clock at, so the spans line up with the host spans and the profiler's
timeline; they land as ``"X"`` events (``cat`` ``"device"``) on one lane
named ``device``.  Without CUDA a device span is its host interval, on
the same lane.  The serving engine flushes after each step and the
trainer after each step's loss read, both of which wait for the device
anyway.

``NullTracer`` is the disabled twin: every method is a no-op and ``span``
returns one shared null context, so instrumented code needs no
``if tracing:`` guards and pays nothing when tracing is off.  The
module-global tracer (``get_tracer``) defaults to the null tracer;
launchers swap in a real one for ``--trace-out``, and ``using(tracer)``
makes an engine's or a trainer's own tracer the ambient one for the code
beneath it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch

__all__ = ["Tracer", "NullTracer", "get_tracer", "set_tracer", "using", "DEVICE_TID"]

# The lane of the device spans.
DEVICE_TID = 2**31 - 1


class Tracer:
    """Chrome-trace event collector.  Thread-safe appends; ``tid`` selects
    the lane (default: per-thread ident, or pass one explicitly to group
    logical tracks such as request slots)."""

    def __init__(self, *, process_name: str = "repro", pid: int = 0):
        self.pid = pid
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        # Device spans closed since the last flush: (name, args, start, end),
        # each end a CUDA event on the card and a host time elsewhere.
        self._pending: list[tuple] = []
        self._cuda: Optional[bool] = None  # decided at the first device span
        self._spare_events: list = []
        self._device_lane = False
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
             args: Optional[dict] = None, device: bool = False):
        """Measure the enclosed block as a complete ("X") event: on the host's
        clock, or with ``device`` on the device's, emitted by ``flush``."""
        if device:
            # The events are recorded inside the profiler's range, so the
            # range's ends bracket them on the host's clock.
            with torch.profiler.record_function(name):
                start = self._mark()
                try:
                    yield self
                finally:
                    end = self._mark()
                    with self._lock:
                        self._pending.append((name, args, start, end))
            return
        tid = threading.get_ident() % 2**31 if tid is None else tid
        t0 = self.now_s()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            self.complete(name, t0, self.now_s() - t0, cat=cat, tid=tid,
                          args=args)

    def _mark(self):
        """A point on the device's clock: a CUDA event recorded on the
        current stream, or the host time where there is no card."""
        if self._cuda is None:
            self._cuda = torch.cuda.is_available()
        if not self._cuda:
            return self.now_s()
        with self._lock:
            ev = self._spare_events.pop() if self._spare_events else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def flush(self) -> None:
        """Emit the device spans closed since the last flush on the
        ``device`` lane.  On the card this records an anchor event, waits
        for it and reads the host clock: each event's host time is that
        reading less its device time to the anchor, so the error is the
        host's wake-up after the wait, and each flush anchors anew."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        if self._cuda:
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            anchor.synchronize()
            t_anchor = self.now_s()

            def host_s(ev) -> float:
                return t_anchor - ev.elapsed_time(anchor) / 1e3
        else:
            def host_s(t: float) -> float:
                return t
        if not self._device_lane:
            self._device_lane = True
            self.thread_name(DEVICE_TID, "device")
        for name, args, start, end in pending:
            t0 = host_s(start)
            self.complete(name, t0, host_s(end) - t0, cat="device", tid=DEVICE_TID, args=args)
        if self._cuda:
            with self._lock:
                self._spare_events.extend(ev for _, _, start, end in pending for ev in (start, end))

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

    def span(self, name, *, cat="", tid=None, args=None, device=False):
        return _NULL_SPAN

    def flush(self) -> None:
        pass

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
_NULL_SPAN = contextlib.nullcontext(NULL_TRACER)
_current = NULL_TRACER


def get_tracer():
    """The ambient tracer (``NullTracer`` unless a launcher installed one)."""
    return _current


def set_tracer(tracer) -> None:
    global _current
    _current = tracer if tracer is not None else NULL_TRACER


@contextlib.contextmanager
def using(tracer):
    """Make ``tracer`` the ambient tracer inside the block; the one before it
    comes back on leaving, also when the block raises."""
    global _current
    previous = _current
    set_tracer(tracer)
    try:
        yield tracer
    finally:
        _current = previous
