"""Labeled Counter/Gauge/Histogram registry with Prometheus/JSON exposition
(a copy of ``repro.obs.metrics``), and a build watcher in place of the
reference's XLA compile watcher.

Zero-dependency (stdlib only) metrics substrate for the whole repo: the
serve engine, the trainer, and the fault-tolerance layer all report through
a ``Registry``.  Design points:

  * **prometheus_client-shaped API** — ``registry.counter(name, help,
    labelnames)`` returns a family; ``family.labels(phase="decode").inc()``
    addresses a child; families with no labelnames delegate directly
    (``family.inc()``).
  * **Fixed-bucket histograms** for exposition (cumulative ``_bucket{le=}``
    series, Prometheus semantics) plus a bounded reservoir of raw samples
    so ``percentile(q)`` matches ``numpy.percentile`` exactly until the
    reservoir cap, then degrades to a sliding-window estimate.
  * **Global off switch** — ``set_enabled(False)`` turns every mutation
    (``inc``/``set``/``observe``) into a guarded early return; the no-op
    overhead is pinned near-zero by the reference's ``tests/test_obs.py``.
  * ``snapshot()`` exports a nested plain dict (JSON-able); ``to_prometheus()``
    emits the text exposition format; ``to_json()`` is ``snapshot()`` dumped.
  * ``JitCompileWatcher`` / ``watch_jit_compiles`` count the executables the
    port builds: the kernel libraries ``kernels/_build.py`` compiles with
    ``nvcc`` at first use, one log record a finished build; loading a
    library already built (the cache hit) is silent, as XLA's is.
"""

from __future__ import annotations

import bisect
import json
import logging
import math
import threading
from collections import deque
from contextlib import contextmanager
from typing import Iterable, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_BUCKETS",
    "default_registry",
    "enabled",
    "set_enabled",
    "JitCompileWatcher",
    "watch_jit_compiles",
]


class _State:
    """Module-global enable flag.  An object attribute (not a bare module
    global) so the hot-path check is one LOAD_ATTR and ``set_enabled``
    never has to touch importers' references."""

    __slots__ = ("on",)

    def __init__(self):
        self.on = True


_STATE = _State()


def enabled() -> bool:
    return _STATE.on


def set_enabled(flag: bool) -> None:
    """Globally enable/disable all metric mutations (no-op path when off)."""
    _STATE.on = bool(flag)


# Latency-oriented default buckets: 10 µs .. 60 s, roughly x2.5 per step.
DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Raw-sample reservoir per histogram child; under this many observations the
# percentile math is exact (numpy-equivalent), beyond it a sliding window.
DEFAULT_SAMPLE_CAP = 8192


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers bare, else repr."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames: tuple, key: tuple) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, key))
    return "{" + inner + "}"


class _Family:
    """Base for the three metric families: owns the (labelvalues -> child)
    map and delegates mutations to the default (unlabeled) child."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _make_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally or by name")
            values = tuple(kv[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; address it via .labels()")
        return self.labels()

    def children(self) -> dict[tuple, object]:
        return dict(self._children)


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _STATE.on:
            return
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    @property
    def value(self) -> float:
        return self._default().value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        if not _STATE.on:
            return
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _STATE.on:
            return
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    __slots__ = ("uppers", "bucket_counts", "sum", "count", "samples")

    def __init__(self, buckets: tuple, sample_cap: int):
        self.uppers = buckets
        self.bucket_counts = [0] * (len(buckets) + 1)  # + overflow (+Inf)
        self.sum = 0.0
        self.count = 0
        self.samples: deque = deque(maxlen=sample_cap)

    def observe(self, v: float) -> None:
        if not _STATE.on:
            return
        v = float(v)
        self.bucket_counts[bisect.bisect_left(self.uppers, v)] += 1
        self.sum += v
        self.count += 1
        self.samples.append(v)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; numpy-style linear interpolation over the retained
        sample reservoir (exact while count <= sample cap)."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        if len(s) == 1:
            return s[0]
        rank = (q / 100.0) * (len(s) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(s) - 1)
        frac = rank - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """Prometheus-style (le, cumulative_count) rows, ending at +Inf."""
        rows, cum = [], 0
        for upper, c in zip(self.uppers, self.bucket_counts):
            cum += c
            rows.append((upper, cum))
        rows.append((math.inf, cum + self.bucket_counts[-1]))
        return rows


class Histogram(_Family):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        *,
        buckets: tuple = DEFAULT_BUCKETS,
        sample_cap: int = DEFAULT_SAMPLE_CAP,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self.sample_cap = sample_cap

    def _make_child(self):
        return _HistogramChild(self.buckets, self.sample_cap)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    def summary(self) -> dict:
        return self._default().summary()

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum


class Registry:
    """Named metric store.  ``counter/gauge/histogram`` are idempotent
    get-or-create (re-registering the same name with the same kind returns
    the existing family)."""

    def __init__(self):
        self._metrics: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"{name} already registered as {existing.kind}"
                    )
                return existing
            fam = cls(name, help, labelnames, **kw)
            self._metrics[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self, name, help="", labelnames=(),
        buckets=DEFAULT_BUCKETS, sample_cap=DEFAULT_SAMPLE_CAP,
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames,
            buckets=buckets, sample_cap=sample_cap,
        )

    def get(self, name: str) -> Optional[_Family]:
        return self._metrics.get(name)

    def metrics(self) -> dict[str, _Family]:
        return dict(self._metrics)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Nested plain-dict export: kind -> name -> labelstring -> value
        (histograms export their percentile summary)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, fam in sorted(self._metrics.items()):
            vals = {}
            for key, child in sorted(fam.children().items()):
                lk = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    vals[lk] = child.summary()
                else:
                    vals[lk] = child.value
            out[fam.kind + "s"][name] = vals
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for name, fam in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                ls = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    for upper, cum in child.cumulative_buckets():
                        le = _label_str(
                            fam.labelnames + ("le",), key + (_fmt(upper),)
                        )
                        lines.append(f"{name}_bucket{le} {cum}")
                    lines.append(f"{name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{ls} {_fmt(float(child.count))}")
                else:
                    lines.append(f"{name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-global registry (ad-hoc consumers; subsystems that need
    isolation — e.g. one ``ServeEngine`` per registry — create their own)."""
    return _DEFAULT


# ---------------------------------------------------------------------------
# Kernel-build counter (the reference's XLA compile-event counter)
# ---------------------------------------------------------------------------

BUILD_LOGGER = "repro_torch.kernels.build"
BUILD_MESSAGE = "Finished nvcc build of"  # kernels/_build.py's record, one a build


class JitCompileWatcher(logging.Handler):
    """Counts the kernel libraries built (``kernels/_build.py`` logs
    "Finished nvcc build of <name> in <t> sec" once a build; a library
    already built loads silently).  Optionally forwards each build into a
    registry counter (child or unlabeled family)."""

    def __init__(self, counter=None):
        super().__init__(level=logging.DEBUG)
        self.count = 0
        self.counter = counter

    def emit(self, record):
        if BUILD_MESSAGE in record.getMessage():
            self.count += 1
            if self.counter is not None:
                self.counter.inc()

    def reset(self):
        self.count = 0

    def install(self):
        logger = logging.getLogger(BUILD_LOGGER)
        self._prev = logger.level
        logger.setLevel(logging.DEBUG)
        logger.addHandler(self)
        return self

    def uninstall(self):
        logger = logging.getLogger(BUILD_LOGGER)
        logger.removeHandler(self)
        logger.setLevel(getattr(self, "_prev", logging.NOTSET))


@contextmanager
def watch_jit_compiles(counter=None):
    """Context manager: yields an installed ``JitCompileWatcher``."""
    watcher = JitCompileWatcher(counter).install()
    try:
        yield watcher
    finally:
        watcher.uninstall()
