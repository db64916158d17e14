"""Shared neural-net building blocks (counterpart of ``repro.models.layers``):
plain functions over parameter dicts."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.quant import Quant
from .parallel import is_dtensor, mlp as sharded_mlp

_FP = Quant()  # no-op policy for call sites without a config


# -- initializers ---------------------------------------------------------------
# jax.random's numbers cannot be reproduced; tests bridge the reference's
# weights instead (repro_torch.bridge).

class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: the initializers then give shapes and dtypes only
    (``models.param_shapes``)."""

    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype) -> torch.Tensor:
    w = randn(gen, (in_dim, out_dim))
    return (w * (1.0 / np.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    w = randn(gen, (vocab, dim))
    return (w * 0.02).to(dtype)


# -- norms -----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dtype)


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def apply_norm(x: torch.Tensor, params: Optional[dict], norm_type: str) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"] if params else None)
    if norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if norm_type == "non_parametric":  # OLMo: LN without learnable params
        return layer_norm(x, None, None)
    raise ValueError(norm_type)


def norm_params(d: int, norm_type: str, dtype, device) -> Optional[dict]:
    if norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        return {
            "scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device),
        }
    if norm_type == "non_parametric":
        return None
    raise ValueError(norm_type)


# -- rotary embeddings -------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def _rotate_halves(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs) by ``angles`` [B, S, d/2]."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # [B, S, H, d]
    positions: torch.Tensor,  # [B, S]
    theta: float = 10000.0,
) -> torch.Tensor:
    freqs = torch.as_tensor(
        rope_frequencies(x.shape[-1], theta), dtype=torch.float32, device=x.device
    )
    return _rotate_halves(x, positions[..., None].float() * freqs)


def apply_mrope(
    x: torch.Tensor,  # [B, S, H, d]
    positions: torch.Tensor,  # [B, S, 3] (t, h, w) — qwen2-vl M-RoPE
    sections: tuple[int, int, int],
    theta: float = 1_000_000.0,
) -> torch.Tensor:
    """Multimodal RoPE: the head_dim/2 frequency slots are partitioned into
    (temporal, height, width) sections, each rotated by its own position id."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d // 2)
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=torch.float32, device=x.device)
    sec_id = torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)), device=x.device)
    pos = positions.float()[:, :, sec_id]  # [B, S, d/2]
    return _rotate_halves(x, pos * freqs)


# -- MLPs --------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, d: int, d_ff: int, mlp_type: str, dtype) -> dict:
    if mlp_type == "swiglu":
        return {
            "gate": dense_init(gen, d, d_ff, dtype),
            "up": dense_init(gen, d, d_ff, dtype),
            "down": dense_init(gen, d_ff, d, dtype),
        }
    return {"up": dense_init(gen, d, d_ff, dtype), "down": dense_init(gen, d_ff, d, dtype)}


def mlp_forward(
    x: torch.Tensor, params: dict, mlp_type: str, quant: Quant = _FP
) -> torch.Tensor:
    if is_dtensor(x):
        return sharded_mlp(lambda a, p: mlp_forward(a, p, mlp_type, quant), x, params, quant)

    def dot(a, w):
        return quant.dot(a, w, "mlp")

    if mlp_type == "swiglu":
        h = F.silu(dot(x, params["gate"])) * dot(x, params["up"])
    elif mlp_type == "squared_relu":  # nemotron-4
        h = torch.square(F.relu(dot(x, params["up"])))
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(dot(x, params["up"]), approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return dot(h, params["down"])
