from .kernel import pwl_exp2_cuda  # noqa: F401
