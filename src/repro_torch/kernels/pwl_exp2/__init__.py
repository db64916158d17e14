from .kernel import pwl_exp2_cuda  # noqa: F401
from .ops import pwl_exp2  # noqa: F401
from .ref import pwl_exp2_reference  # noqa: F401
