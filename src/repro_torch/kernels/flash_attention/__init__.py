from .kernel import flash_attention_fwd, flash_attention_fwd_plain  # noqa: F401
from .kernel_bwd import flash_attention_bwd, flash_attention_bwd_plain  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import attention_reference  # noqa: F401
