from .model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    insert_cache,
    lm_loss,
    param_shapes,
    prefill_step,
    rollback_cache,
    verify_step,
)
