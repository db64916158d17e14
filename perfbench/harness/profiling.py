"""The ``--trace 1`` run's device trace: ``torch.profiler`` (CUPTI) over
``trace_s`` seconds of the run, started and stopped between two steps of
the program (serving: right after the window closes, the traffic still
running; training: the steps that start in the window's last ``trace_s``
seconds), reduced to what the per-layer readers need.  Starting and
stopping the profiler takes seconds on the host.

  * ``busy_s``: the union of the intervals in which a kernel, copy or
    memset ran on the device; ``window_s``: the host time from start to
    stop (the stop waits for the device);
  * ``kernels``: device seconds and launches by kernel name;
  * ``gaps``: the longest stretches with nothing on the device, each named
    by what the host was doing at its middle (outermost and innermost host
    range or op).
"""

from __future__ import annotations

import gc
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
TOP = 10


def sync() -> None:
    """Wait for the card, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def free() -> None:
    """Return what the process no longer holds to the card, before the
    reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Capture:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> dict:
        if self.summary is None:
            self.summary = summarize(self.prof.events(), self.t1 - self.t0)
            self.prof = None
        return self.summary


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == CPU:
            host.append((e.name, start, end))
        elif e.device_type == CUDA and not getattr(e, "is_user_annotation", False):
            dev.append((e.name, start, end))
    # A host range (record_function) also shows on the device's timeline,
    # spanning its kernels and the gaps between them: it is no operation.
    annotations = {h[0] for h in host}
    dev = [d for d in dev if d[0] not in annotations]
    kernels = defaultdict(lambda: [0.0, 0])
    for name, a, b in dev:
        kernels[name][0] += (b - a) / 1e6
        kernels[name][1] += 1
    merged = _union((a, b) for _, a, b in dev)
    busy = sum(b - a for a, b in merged) / 1e6
    gaps = []
    if host:
        lo, hi = min(h[1] for h in host), max(h[2] for h in host)
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        spans = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        spans.sort(key=lambda ab: ab[0] - ab[1])
        for a, b in spans[:TOP]:
            mid = (a + b) / 2
            around = sorted((h for h in host if h[1] <= mid <= h[2]), key=lambda h: h[1] - h[2])
            name = " > ".join(dict.fromkeys([around[0][0], around[-1][0]])) if around else "no host op"
            gaps.append([name, (b - a) / 1e6])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "kernels": {k: {"s": v[0], "n": v[1]} for k, v in kernels.items()},
        "gaps": gaps,
    }


def kernel_seconds(summary: dict, part: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds ``part``."""
    rows = [v for k, v in summary["kernels"].items() if part in k]
    return sum(r["s"] for r in rows), sum(r["n"] for r in rows)


def breakdown(summary: dict) -> dict:
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])[:TOP]
    return {"device_ops": [[k[:120], v["s"]] for k, v in top], "idle_gaps": summary["gaps"]}
