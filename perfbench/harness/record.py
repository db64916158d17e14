"""What one run hands to the metric readers (``perfbench/metrics/*.py``).

Times are host ``time.perf_counter()`` seconds.  ``window`` is the measured
window [open, close).  Serving runs fill ``requests``, training runs
``steps``; a ``--trace 1`` run adds ``spans`` (the program's own tracer
spans: name, start, end, args) and ``trace`` (``profiling.summarize``) of
the slice [``trace_t0``, ``trace_t1``).  ``samples`` holds the served
requests that the output check compared."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Req:
    due: float
    prompt_len: int
    max_new: int
    t_prefill: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)
    done: bool = False
    engine_req: object = None  # the program's Request


@dataclasses.dataclass
class Step:
    t_start: float
    t_end: float
    tokens: int


@dataclasses.dataclass
class Run:
    kind: str  # "serve" | "train"
    model: dict  # the config's port block
    traffic: dict
    window: tuple
    setup_s: float
    requests: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None
    trace_t0: Optional[float] = None
    trace_t1: Optional[float] = None
    samples: list = dataclasses.field(default_factory=list)  # (prompt, served tokens) checked

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t < self.window[1]

    def in_trace(self, t: float) -> bool:
        return self.trace_t0 is not None and self.trace_t0 <= t < self.trace_t1

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def due_in_window(self) -> list:
        return [r for r in self.requests if self.in_window(r.due)]
