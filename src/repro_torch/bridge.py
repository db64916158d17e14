"""Weight bridge: the reference's parameter pytree as this package's dict.

``repro.models.init_params`` gives nested dicts with stacked ``[L, ...]``
layer leaves; after ``jax.tree.map(np.asarray, params)`` (done by the
caller, so that this module needs no JAX) every leaf is a numpy array, and
``params_from_jax`` maps it to a tensor on ``device``.  ``None`` leaves
(non-parametric norms) stay ``None``.  ``to_numpy`` goes the other way for
comparisons, a bf16 tensor as fp32 (exactly).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params_np: Any, device="cuda") -> Any:
    if params_np is None:
        return None
    if isinstance(params_np, dict):
        return {name: params_from_jax(leaf, device) for name, leaf in params_np.items()}
    return _tensor(np.asarray(params_np), device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
