"""Plain oracle for the PWL exp2 kernel (counterpart of
``repro.kernels.pwl_exp2.ref``): ``repro_torch.core.pwl_exp2.pwl_exp2``."""
from repro_torch.core.pwl_exp2 import pwl_exp2 as pwl_exp2_reference  # noqa: F401
