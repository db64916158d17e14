"""Hand-written CUDA kernels for Hopper (``csrc/``), built by ``_build`` at
first use, each beside its plain PyTorch version."""
