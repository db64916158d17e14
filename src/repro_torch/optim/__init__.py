from .adamw import Adafactor, AdafactorState, AdamW, AdamWState, make_optimizer  # noqa: F401
from .grad_compress import (  # noqa: F401
    compress_with_feedback,
    compressed_pmean,
    dequantize_int8,
    init_residual,
    quantize_int8,
)
from .schedules import cosine_with_warmup, linear_warmup_constant  # noqa: F401
