"""Pareto-frontier extraction over (performance, area, accuracy).

The autotuner's real output is the non-dominated set, not a scalar
winner: the paper's 128x128 / 8-segment / exact-fit-SRAM point should
*sit on* this frontier (every knob it fixes is a genuine trade — more
segments buy PWL accuracy for split-LUT area, the single-direction
schedule buys area for cycles, bigger arrays buy throughput for silicon),
and the report shows where.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["OBJECTIVES", "dominates", "pareto_front", "attach_frontier"]

# (record key, direction): the default three-objective trade-off surface.
OBJECTIVES = (
    ("mean_tflops", "max"),
    ("total_um2", "min"),
    ("acc_mre", "min"),
)


def _oriented(rec: dict, objectives) -> tuple:
    """Record -> tuple where larger is always better."""
    out = []
    for key, direction in objectives:
        v = float(rec[key])
        out.append(v if direction == "max" else -v)
    return tuple(out)


def dominates(a: dict, b: dict, objectives=OBJECTIVES) -> bool:
    """True iff ``a`` is >= ``b`` on every objective and > on at least one."""
    av, bv = _oriented(a, objectives), _oriented(b, objectives)
    return all(x >= y for x, y in zip(av, bv)) and any(x > y for x, y in zip(av, bv))


def pareto_front(records: Sequence[dict], objectives=OBJECTIVES) -> list[int]:
    """Indices of the non-dominated records, in input order."""
    front = []
    for i, rec in enumerate(records):
        if not any(
            dominates(other, rec, objectives)
            for j, other in enumerate(records)
            if j != i
        ):
            front.append(i)
    return front


def attach_frontier(records: Sequence[dict], objectives=OBJECTIVES) -> list[int]:
    """Set ``rec["on_frontier"]`` on every record; return frontier indices."""
    front = pareto_front(records, objectives)
    front_set = set(front)
    for i, rec in enumerate(records):
        rec["on_frontier"] = i in front_set
    return front
