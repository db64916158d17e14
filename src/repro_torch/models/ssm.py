"""Mamba2 (SSD) block (counterpart of ``repro.models.ssm``), used by the
zamba2 hybrid architecture.

  * input projection -> (z, x, B, C, dt), causal depthwise conv on (x, B, C);
  * scalar-identity state transition per head: h_t = a_t h_{t-1} +
    dt_t x_t B_t^T, y_t = C_t h_t + D x_t, with log a_t = -exp(A_log) dt_t
    (the reference's code; its docstring says softplus);
  * chunked evaluation: a quadratic term inside each chunk plus the state
    carried from chunk to chunk, a Python loop over the chunks;
  * gated output (silu(z)) + RMSNorm, out projection;
  * single-token recurrent decode with a (conv, ssm) state cache.

The reference computes all of it in ``jnp`` (no Pallas kernel), so this is
plain PyTorch, in the reference's order of operations: the conv is a sum of
K shifted products in the activation dtype (``F.conv1d`` would accumulate
in fp32 and round differently in bf16), decode's conv is the
``bkc,kc->bc`` contraction, dt, the decay, the scan and the state are fp32,
and ``A_log``, ``D`` and ``dt_bias`` are fp32 leaves in any model dtype.

One departure, (f) in ROADMAP §3: ``_ssd_chunked`` masks the intra-chunk
log-decay before the exponential, where the reference masks after it.  The
values are the same; the reference's gradient is NaN where a masked
exponent overflows (chunk 128 at dt ~ 0.8), this one stays finite.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import get_quant
from .layers import dense_init, randn, rms_norm
from .parallel import is_dtensor, replicated


class MambaCache(NamedTuple):
    conv: torch.Tensor  # [B, conv_width - 1, conv_channels], activation dtype
    ssm: torch.Tensor  # [B, H, head_dim, state_dim], fp32


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nheads = d_inner // ssm.head_dim
    conv_ch = d_inner + 2 * ssm.state_dim
    return d_inner, nheads, conv_ch


def mamba_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_ch = _dims(cfg)
    dev = gen.device
    in_dim = 2 * d_inner + 2 * ssm.state_dim + nheads  # z, x, B, C, dt
    conv_w = randn(gen, (ssm.conv_width, conv_ch)) * 0.1
    return {
        "in_proj": dense_init(gen, d, in_dim, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "D": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, d, dtype),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """(z, xbc, dt): xbc is concat(x, B, C)."""
    d_inner, nheads, conv_ch = _dims(cfg)
    return torch.split(proj, [d_inner, conv_ch, nheads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B, S, C], w: [K, C]."""
    kw, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, kw - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(kw))
    return F.silu(out + b)


def _ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]   (P = head_dim)
    dt: torch.Tensor,  # [B, S, H]      (post-softplus)
    a: torch.Tensor,  # [B, S, H]      log-decay per step: -exp(A_log)*dt
    B: torch.Tensor,  # [B, S, N]
    C: torch.Tensor,  # [B, S, N]
    chunk: int,
    h0: torch.Tensor | None = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y [B,S,H,P], h_final [B,H,P,N])."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    ac = a.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    # Cumulative log-decay within each chunk.
    cum = torch.cumsum(ac, dim=2)  # [B, NC, L, H]
    total = cum[:, :, -1]  # [B, NC, H]

    # Intra-chunk: y_intra[t] = sum_{u<=t} exp(cum[t]-cum[u]) (C_t . B_u) dt_u x_u.
    # Departure (f): the pairs u > t are masked to -inf before the exp (the
    # reference exponentiates them, up to ~+100 at chunk 128, then masks).
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    log_decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,NC,L,L,H]
    decay = torch.exp(torch.where(mask[None, None, :, :, None], log_decay, float("-inf")))
    scores = torch.einsum("bctn,bcun->bctu", Cc, Bc)  # [B,NC,L,L]
    w = scores[..., None] * decay * dtc[:, :, None, :, :]  # [B,NC,L,L,H]
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", w, xc)

    # Chunk-boundary states: h_chunk = sum_u exp(total - cum[u]) dt_u x_u B_u^T
    state_decay = torch.exp(total[:, :, None, :] - cum)  # [B,NC,L,H]
    xb = torch.einsum("bcuh,bcuhp,bcun->bchpn", dtc * state_decay, xc, Bc)

    # Inter-chunk recurrence over the chunk index.
    h_prev = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) if h0 is None else h0
    starts = []
    for c in range(nc):
        starts.append(h_prev)
        h_prev = h_prev * torch.exp(total[:, c])[..., None, None] + xb[:, c]
    h_starts = torch.stack(starts, dim=1)  # [B, NC, H, P, N] (state at chunk start)

    # Inter-chunk contribution: y_inter[t] = exp(cum[t]) * (C_t . h_start)
    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, h_starts) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, h_prev


def mamba_forward(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: [B, S, d_model]."""
    if is_dtensor(x):
        return replicated(lambda a, p, _s: mamba_forward(a, p, cfg), x, params)
    ssm = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    b, s, _ = x.shape
    quant = get_quant(cfg)

    proj = quant.dot(x, params["in_proj"], "ssm")
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xin, B, C = torch.split(xbc, [d_inner, ssm.state_dim, ssm.state_dim], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # [B,S,H]
    a = -torch.exp(params["A_log"])[None, None, :] * dt  # log decay
    xh = xin.reshape(b, s, nheads, ssm.head_dim).float()

    # Pad the sequence to a chunk multiple.
    chunk = min(ssm.chunk_size, s)
    pad = (-s) % chunk
    B, C = B.float(), C.float()
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, a, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, a, B, C))
    else:
        xh_p = xh

    y, _ = _ssd_chunked(xh_p, dt, a, B, C, chunk)
    y = y[:, :s]
    y = y + params["D"][None, None, :, None] * xh  # skip connection
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["norm_scale"])
    return quant.dot(y, params["out_proj"], "ssm")


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> MambaCache:
    ssm = cfg.ssm
    d_inner, nheads, conv_ch = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, ssm.conv_width - 1, conv_ch), dtype=dtype, device=device),
        ssm=torch.zeros((batch, nheads, ssm.head_dim, ssm.state_dim), dtype=torch.float32, device=device),
    )


def mamba_decode(
    x: torch.Tensor,  # [B, 1, d_model]
    params: dict,
    cfg: ModelConfig,
    cache: MambaCache,
) -> tuple[torch.Tensor, MambaCache]:
    """Single-token recurrent step -> (y [B, 1, d_model], new cache).  The
    new cache is made of new tensors; ``cache`` is left as it was."""
    if is_dtensor(x):
        return replicated(lambda a, p, st: mamba_decode(a, p, cfg, st), x, params, cache)
    ssm = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    b = x.shape[0]
    quant = get_quant(cfg)

    proj = quant.dot(x, params["in_proj"], "ssm")
    z, xbc, dt_raw = _split_proj(proj, cfg)

    # Conv state update: window = [cache.conv, xbc]
    window = torch.cat([cache.conv, xbc[:, 0:1, :]], dim=1)  # [B, K, C]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"])
    new_conv = window[:, 1:, :]

    xin, B, C = torch.split(conv_out, [d_inner, ssm.state_dim, ssm.state_dim], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # [B,H]
    a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt)  # [B,H]
    xh = xin.reshape(b, nheads, ssm.head_dim).float()

    h_new = cache.ssm * a[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xh, B.float())
    y = torch.einsum("bn,bhpn->bhp", C.float(), h_new)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["norm_scale"])
    return quant.dot(y, params["out_proj"], "ssm"), MambaCache(conv=new_conv, ssm=h_new)
