from .engine import (  # noqa: F401
    Request,
    ServeEngine,
    default_buckets,
    request_latencies,
    sequential_greedy_decode,
)
from .serve_step import SamplingConfig, make_decode_step, make_prefill_step, sample_logits  # noqa: F401
