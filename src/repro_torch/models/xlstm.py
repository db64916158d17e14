"""xLSTM blocks (arXiv:2405.04517; counterpart of ``repro.models.xlstm``):
mLSTM (matrix memory) and sLSTM (scalar memory, strictly recurrent) with
exponential gating and max-stabilisers.  Both have a full-sequence forward
(a Python loop over time steps, the reference's ``lax.scan``) and a
single-token decode with an explicit state.

xlstm-125m alternates mLSTM and sLSTM blocks and runs no attention, so the
paper's technique does not apply to it; the reference computes these blocks
in ``jnp`` and so does this module, in plain PyTorch.  As in the reference:
the stabiliser ``m`` starts at -1e30 in fp32, ``k`` is scaled by 1/sqrt(P)
inside the step, the mLSTM denominator is clamped at 1 and the sLSTM
normaliser at 1e-6, sLSTM casts ``h`` to the input dtype before its
recurrent products, and every projection goes through
``quant.dot(..., "xlstm")``.  Decode steps return new state tensors and
leave the old ones as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import get_quant
from .layers import dense_init, rms_norm
from .parallel import is_dtensor, replicated


class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, P, P] matrix memory
    n: torch.Tensor  # [B, H, P] normalizer
    m: torch.Tensor  # [B, H] stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, D]
    n: torch.Tensor  # [B, D]
    m: torch.Tensor  # [B, D]
    h: torch.Tensor  # [B, D] recurrent output


# -- mLSTM ---------------------------------------------------------------------

def mlstm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dev = gen.device
    return {
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wi": dense_init(gen, d, h, dtype),  # input gate (exp)
        "wf": dense_init(gen, d, h, dtype),  # forget gate
        "wo": dense_init(gen, d, d, dtype),
        "bi": torch.zeros((h,), dtype=dtype, device=dev),
        "bf": torch.ones((h,), dtype=dtype, device=dev),  # bias toward remembering
        "norm_scale": torch.ones((d,), dtype=dtype, device=dev),
    }


def _mlstm_step(state: MLSTMState, inp, head_dim: int):
    q, k, v, i_raw, f_raw = inp  # q/k/v: [B,H,P]; gates: [B,H]
    logf = -F.softplus(-f_raw)  # log sigmoid(f)
    m_new = torch.maximum(logf + state.m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(logf + state.m - m_new)
    # A true division by the fp32 sqrt, as the reference's (a device tensor:
    # CUDA divides by a host scalar through its reciprocal).
    k_s = k / torch.sqrt(torch.full((), head_dim, dtype=torch.float32, device=k.device))
    c_new = f_g[..., None, None] * state.c + i_g[..., None, None] * (v[..., :, None] * k_s[..., None, :])
    n_new = f_g[..., None] * state.n + i_g[..., None] * k_s
    num = torch.einsum("bhpq,bhq->bhp", c_new, q)
    den = torch.clamp(torch.abs(torch.einsum("bhp,bhp->bh", n_new, q)), min=1.0)
    return MLSTMState(c_new, n_new, m_new), num / den[..., None]


def _mlstm_inputs(x, params, cfg: ModelConfig):
    """q, k, v [B, S, H, P] and the gates' pre-activations [B, S, H], fp32."""
    b, s, d = x.shape
    nh = cfg.num_heads
    quant = get_quant(cfg)

    def qd(w):
        return quant.dot(x, params[w], "xlstm")

    q, k, v = (qd(w).reshape(b, s, nh, d // nh).float() for w in ("wq", "wk", "wv"))
    i_raw = (qd("wi") + params["bi"]).float()
    f_raw = (qd("wf") + params["bf"]).float()
    return q, k, v, i_raw, f_raw


def _mlstm_out(h, params, cfg: ModelConfig, dtype):
    b, s = h.shape[:2]
    h = rms_norm(h.reshape(b, s, cfg.d_model).to(dtype), params["norm_scale"])
    return get_quant(cfg).dot(h, params["wo"], "xlstm")


def mlstm_forward(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    if is_dtensor(x):
        return replicated(lambda a, p, _s: mlstm_forward(a, p, cfg), x, params)
    inputs = _mlstm_inputs(x, params, cfg)
    state = init_mlstm_state(cfg, x.shape[0], x.device)
    p = cfg.d_model // cfg.num_heads
    hs = []
    for t in range(x.shape[1]):
        state, h = _mlstm_step(state, tuple(a[:, t] for a in inputs), p)
        hs.append(h)
    return _mlstm_out(torch.stack(hs, dim=1), params, cfg, x.dtype)


def mlstm_decode(x, params, cfg: ModelConfig, state: MLSTMState):
    if is_dtensor(x):
        return replicated(lambda a, p, st: mlstm_decode(a, p, cfg, st), x, params, state)
    inputs = _mlstm_inputs(x, params, cfg)
    new_state, h = _mlstm_step(state, tuple(a[:, 0] for a in inputs), cfg.d_model // cfg.num_heads)
    return _mlstm_out(h[:, None], params, cfg, x.dtype), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    nh = cfg.num_heads
    p = cfg.d_model // nh
    return MLSTMState(
        c=torch.zeros((batch, nh, p, p), dtype=torch.float32, device=device),
        n=torch.zeros((batch, nh, p), dtype=torch.float32, device=device),
        m=torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    )


# -- sLSTM ---------------------------------------------------------------------

def slstm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    p = {"norm_scale": torch.ones((d,), dtype=dtype, device=gen.device)}
    for gate in ("i", "f", "z", "o"):
        p[f"w{gate}"] = dense_init(gen, d, d, dtype)
        p[f"r{gate}"] = dense_init(gen, d, d, dtype)  # recurrent
        p[f"b{gate}"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


def _slstm_step(params, state: SLSTMState, x_t: torch.Tensor, quant):
    """x_t: [B, D] (pre-activations use the recurrent h)."""
    h_prev = state.h.to(x_t.dtype)

    def pre(g):
        return (
            quant.dot(x_t, params[f"w{g}"], "xlstm")
            + quant.dot(h_prev, params[f"r{g}"], "xlstm")
            + params[f"b{g}"]
        ).float()

    i_raw, f_raw, z_raw, o_raw = pre("i"), pre("f"), pre("z"), pre("o")
    logf = -F.softplus(-f_raw)
    m_new = torch.maximum(logf + state.m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(logf + state.m - m_new)
    c_new = f_g * state.c + i_g * torch.tanh(z_raw)
    n_new = f_g * state.n + i_g
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c_new, n_new, m_new, h_new), h_new


def slstm_forward(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    if is_dtensor(x):
        return replicated(lambda a, p, _s: slstm_forward(a, p, cfg), x, params)
    state = init_slstm_state(cfg, x.shape[0], x.device)
    quant = get_quant(cfg)
    hs = []
    for t in range(x.shape[1]):
        state, h = _slstm_step(params, state, x[:, t], quant)
        hs.append(h)
    return rms_norm(torch.stack(hs, dim=1).to(x.dtype), params["norm_scale"])


def slstm_decode(x, params, cfg: ModelConfig, state: SLSTMState):
    if is_dtensor(x):
        return replicated(lambda a, p, st: slstm_decode(a, p, cfg, st), x, params, state)
    new_state, h = _slstm_step(params, state, x[:, 0], get_quant(cfg))
    return rms_norm(h[:, None, :].to(x.dtype), params["norm_scale"]), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    """Each leaf its own tensor: caches are written in place, slot by slot."""
    def zeros():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)

    m = torch.full((batch, cfg.d_model), -1e30, dtype=torch.float32, device=device)
    return SLSTMState(c=zeros(), n=zeros(), m=m, h=zeros())
