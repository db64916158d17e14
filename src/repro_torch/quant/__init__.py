"""``repro_torch.quant`` — the quantization policy.  Only the
full-precision policy runs in this port so far; int8 is a later slice."""

from .config import LAYER_CLASSES, QUANT_FLAGS, QuantConfig, parse_quant  # noqa: F401
from .policy import Quant, get_quant  # noqa: F401
