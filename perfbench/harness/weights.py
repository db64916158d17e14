"""Seeded random weights, made on the device in a few large calls.

The dict has the program's layout (``repro_torch.models.init_params``):
``embed`` [V, d], ``final_norm``, ``lm_head`` [d, V] when untied, and
``layers`` with stacked ``[L, ...]`` leaves: ``attn_norm``/``mlp_norm``
(None for a non-parametric norm, else ``{"scale"}`` ones), ``attn``
(``wq`` [L, d, H*hd], ``wk``/``wv`` [L, d, Hkv*hd], ``wo`` [L, H*hd, d],
``q_norm``/``k_norm`` [L, hd] with QK-norm) and ``mlp`` (``gate``/``up``
[L, d, ff], ``down`` [L, ff, d]) or ``moe`` (``router`` [L, d, E] in
float32, ``gate``/``up`` [L, E, d, ff], ``down`` [L, E, ff, d]).

A projection is N(0, 1) / sqrt(fan_in) and the embedding N(0, 0.02), as
the program's initialisers draw them; one ``randn`` per stacked leaf in
the served dtype, from one generator on the device.  The benchmark hands
the same tensors to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def make(m: dict, seed: int, device) -> dict:
    dtype = getattr(torch, m["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    n_layers, d, hd = m["num_layers"], m["d_model"], m["head_dim"]
    nh, nkv = m["num_heads"], m["num_kv_heads"]

    def randn(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(std)

    def proj(lead, fan_in, fan_out, dt=dtype):
        return randn((*lead, fan_in, fan_out), 1.0 / math.sqrt(fan_in), dt)

    def norm():
        if m["norm_type"] == "non_parametric":
            return None
        return {"scale": torch.ones((n_layers, d), dtype=dtype, device=device)}

    attn = {"wq": proj((n_layers,), d, nh * hd), "wk": proj((n_layers,), d, nkv * hd),
            "wv": proj((n_layers,), d, nkv * hd), "wo": proj((n_layers,), nh * hd, d)}
    if m.get("qk_norm"):
        attn["q_norm"] = torch.ones((n_layers, hd), dtype=dtype, device=device)
        attn["k_norm"] = torch.ones((n_layers, hd), dtype=dtype, device=device)
    layers = {"attn_norm": norm(), "attn": attn, "mlp_norm": norm()}
    moe = m.get("moe")
    if moe is None:
        ff = m["d_ff"]
        layers["mlp"] = {"gate": proj((n_layers,), d, ff), "up": proj((n_layers,), d, ff),
                         "down": proj((n_layers,), ff, d)}
    else:
        e, ff = moe["num_experts"], moe["d_ff_expert"]
        layers["moe"] = {"router": proj((n_layers,), d, e, torch.float32),
                         "gate": proj((n_layers, e), d, ff), "up": proj((n_layers, e), d, ff),
                         "down": proj((n_layers, e), ff, d)}
    params = {"embed": randn((m["vocab_size"], d), 0.02),
              "final_norm": None if m["norm_type"] == "non_parametric"
              else {"scale": torch.ones((d,), dtype=dtype, device=device)}}
    if not m.get("tie_embeddings"):
        params["lm_head"] = randn((d, m["vocab_size"]), 0.02)
    params["layers"] = layers
    return params
