"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The module names follow ``repro`` so that each counterpart is easy to find.
Parameters are plain dicts with the reference's keys and stacked ``[L, ...]``
layer leaves (``repro_torch.bridge`` turns a ``repro`` pytree into one).
Entry points take an explicit ``device`` and default to ``"cuda"``; every
attention kernel that ``repro`` wrote in Pallas is a hand-written CUDA kernel
here (``repro_torch.kernels``).  This package never imports ``jax`` or
``repro``.
"""

import torch

# float32 products must stay float32 on the card: TF32 keeps ~3 decimal
# digits, and the port is held to the reference at float32 tolerances.
# (Matmul TF32 is off by default in PyTorch; cuDNN TF32 is on by default.)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
