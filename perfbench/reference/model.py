"""Plain PyTorch reference of the benchmark's transformer models, in float32.

It follows the published descriptions of the configurations under
``perfbench/configs`` (OLMo-1B: non-parametric LayerNorm, SwiGLU, RoPE, tied
embeddings; Qwen3-MoE: RMSNorm, QK-norm, GQA, top-k routed experts with
renormalised probabilities) and imports nothing but ``torch``.  No kernel,
no cache, no batching: attention is the materialised causal softmax, in
blocks of query rows so that long prompts fit.  Matmuls run in float32 with
TF32 off.

Weights are the benchmark's own tensors (the dict layout in
``perfbench/harness/weights.py``: stacked ``[L, ...]`` leaves); each layer
is read and upcast to float32 only while it runs, so a model whose float32
copy would not fit on the card still runs.

Expert capacity.  A configuration that states a ``capacity_factor``
serves its prompt by the capacity rule of the GShard family, as the
configuration file sets out: over ``T`` routed tokens each expert keeps at
most ``max(int(T * k * capacity_factor / E), 1)`` (token, expert) copies,
first come first kept in token order (within a token, in the order of its
top-k); a dropped copy adds nothing.  Generated tokens route without
capacity (each token's output depends on itself alone).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATTN_ROWS = 1024  # query rows per attention block
LOGIT_ROWS = 2048  # rows per block of the output projection


def _f(t):
    return None if t is None else t.float()


EXPERT_BANKS = ("gate", "up", "down")


def _layer(weights: dict, i: int) -> dict:
    """Layer ``i``'s weights, upcast to float32; expert banks are left as
    they are and upcast one expert at a time."""
    def pick(tree, in_moe=False):
        if isinstance(tree, dict):
            return {k: (tree[k] if in_moe and k in EXPERT_BANKS else pick(v, k == "moe"))
                    for k, v in tree.items()}
        return None if tree is None else tree[i].float()
    return pick(weights["layers"])


def norm(x, m: dict, scale=None):
    if m["norm_type"] == "non_parametric":
        return F.layer_norm(x, (x.shape[-1],), eps=1e-5)
    if m["norm_type"] == "rmsnorm":
        y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
        return y if scale is None else y * scale
    raise ValueError(m["norm_type"])


def rope(x, positions, theta: float):
    """Rotate the two halves of each head (x [S, H, d], positions [S])."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = positions[:, None].float() * freqs.float()[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, w: dict, m: dict, positions):
    """Causal GQA self-attention over one sequence h [S, d_model]."""
    s = h.shape[0]
    hd, nh, nkv = m["head_dim"], m["num_heads"], m["num_kv_heads"]
    q = (h @ w["wq"]).reshape(s, nh, hd)
    k = (h @ w["wk"]).reshape(s, nkv, hd)
    v = (h @ w["wv"]).reshape(s, nkv, hd)
    if m.get("qk_norm"):
        q = norm(q, {"norm_type": "rmsnorm"}, w["q_norm"])
        k = norm(k, {"norm_type": "rmsnorm"}, w["k_norm"])
    q, k = rope(q, positions, m["rope_theta"]), rope(k, positions, m["rope_theta"])
    rep = nh // nkv
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [H, S, d]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    for r0 in range(0, s, ATTN_ROWS):
        r1 = min(r0 + ATTN_ROWS, s)
        sc = q[:, r0:r1] @ k[:, :r1].transpose(1, 2) / math.sqrt(hd)
        causal = torch.arange(r1, device=h.device)[None, :] <= torch.arange(r0, r1, device=h.device)[:, None]
        sc = sc.masked_fill(~causal, float("-inf"))
        out[:, r0:r1] = torch.softmax(sc, dim=-1) @ v[:, :r1]
    return out.transpose(0, 1).reshape(s, nh * hd) @ w["wo"]


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(x, w: dict, m: dict, capacity_rows: int = 0, capacity_tokens: int = 0):
    """Routed experts over x [S, d].  Rows [0, capacity_rows) follow the
    capacity rule over ``capacity_tokens`` routed tokens; the rest route
    without capacity."""
    cfg = m["moe"]
    e, k = cfg["num_experts"], cfg["top_k"]
    probs = torch.softmax(x @ w["router"], dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    keep = torch.ones_like(top_p, dtype=torch.bool)
    if capacity_rows:
        cap = max(int(capacity_tokens * k * cfg["capacity_factor"] / e), 1)
        flat = top_e[:capacity_rows].reshape(-1)
        # A copy's rank among the earlier copies (token order, then top-k
        # order) that chose the same expert: first come, first kept.
        earlier = torch.cumsum(F.one_hot(flat, e), dim=0) - 1
        rank = earlier.gather(1, flat[:, None])[:, 0]
        keep[:capacity_rows] = (rank < cap).reshape(capacity_rows, k)
    y = torch.zeros_like(x)
    for ex in range(e):
        rows, slot = torch.nonzero((top_e == ex) & keep, as_tuple=True)
        if rows.numel():
            out = swiglu(x[rows], w["gate"][ex].float(), w["up"][ex].float(), w["down"][ex].float())
            y.index_add_(0, rows, out * top_p[rows, slot, None])
    return y


def forward(weights: dict, m: dict, tokens: torch.Tensor, capacity_rows: int = 0,
            capacity_tokens: int = 0, first_row: int = 0) -> torch.Tensor:
    """Logits [S - first_row, V] in float32 of rows [first_row, S) of one
    sequence ``tokens`` [S]."""
    s = tokens.shape[0]
    positions = torch.arange(s, device=tokens.device)
    x = weights["embed"][tokens].float()
    for i in range(m["num_layers"]):
        w = _layer(weights, i)
        h = norm(x, m, (w.get("attn_norm") or {}).get("scale"))
        x = x + attention(h, w["attn"], m, positions)
        h = norm(x, m, (w.get("mlp_norm") or {}).get("scale"))
        if m.get("moe") is None:
            x = x + swiglu(h, w["mlp"]["gate"], w["mlp"]["up"], w["mlp"]["down"])
        else:
            wm = {name: (bank[i] if name in EXPERT_BANKS else bank) for name, bank in w["moe"].items()}
            x = x + moe(h, wm, m, capacity_rows, capacity_tokens)
        del w
    x = norm(x, m, _f((weights.get("final_norm") or {}).get("scale")))
    head = (weights["embed"].T if m.get("tie_embeddings") else weights["lm_head"]).float()  # [d, V]
    return torch.cat([x[r:r + LOGIT_ROWS] @ head for r in range(first_row, s, LOGIT_ROWS)])

