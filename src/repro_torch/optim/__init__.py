from .adamw import Adafactor, AdafactorState, AdamW, AdamWState, make_optimizer  # noqa: F401
from .schedules import cosine_with_warmup, linear_warmup_constant  # noqa: F401
