"""Small helpers the metric readers share."""

from __future__ import annotations

import numpy as np


def p95(values) -> float | None:
    """The 95th percentile (numpy's linear interpolation), None if empty."""
    values = list(values)
    return float(np.percentile(values, 95)) if values else None


def spans(run, name: str, where: str = "window") -> list:
    """The program's spans ``name`` that start in the window or the trace."""
    inside = run.in_window if where == "window" else run.in_trace
    return [s for s in run.spans if s[0] == name and inside(s[1])]
