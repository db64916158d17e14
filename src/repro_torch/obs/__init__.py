"""``repro_torch.obs`` — the metrics registry of ``repro.obs``.  Tracing and
MFU accounting come with ROADMAP queue 1 item 7."""

from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    enabled,
    set_enabled,
)
