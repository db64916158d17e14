"""``repro_torch.obs`` — telemetry: metrics registry, tracing, MFU accounting
(counterpart of ``repro.obs``).

  * :mod:`repro_torch.obs.metrics` — labeled Counter/Gauge/Histogram
    registry with Prometheus-text and JSON exposition and a global off
    switch.
  * :mod:`repro_torch.obs.trace` — Chrome-trace/Perfetto span + event
    tracer with a ``torch.profiler.record_function`` pass-through and
    spans timed on the device's clock; ``NullTracer`` is the free disabled
    twin.
  * :mod:`repro_torch.obs.mfu` — model-FLOPs-utilization accounting against
    the paper's FSA array peak (not the card's).

The serve engine, the trainer and the fault layer report through this
package; ``launch/serve.py`` and ``launch/train.py`` take ``--metrics-out``
and ``--trace-out``.  ``watch_jit_compiles`` counts the executables the
port builds, the CUDA kernel libraries ``kernels/_build.py`` compiles at
first use (the reference's XLA compile watcher); the serve launcher
forwards them to a ``jit_compiles_total`` counter.
"""

from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    JitCompileWatcher,
    Registry,
    default_registry,
    enabled,
    set_enabled,
    watch_jit_compiles,
)
from .mfu import (  # noqa: F401
    PAPER_ARRAY,
    ArrayConfig,
    MFUMeter,
    decode_flops,
    paper_ideal_flops_per_s,
    prefill_flops,
    train_step_flops,
    verify_flops,
)
from .trace import NullTracer, Tracer, get_tracer, set_tracer, using  # noqa: F401
