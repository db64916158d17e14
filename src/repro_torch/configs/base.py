"""Model / run configuration dataclasses and the input-shape registry.

A copy of ``repro.configs.base`` kept as data, so that the configs of the two
packages compare equal field by field.  Only ``activation_dtype`` differs: it
returns a ``torch.dtype``.

``attention_impl`` keeps the reference's three values.  In this package:

  * ``systolic`` and ``pallas`` both go to
    ``repro_torch.kernels.flash_attention.flash_attention``: the hand-written
    CUDA kernel for a tensor on the card, its plain tiled PyTorch version
    (Algorithm 1) for a tensor on the CPU;
  * ``naive`` is the materialised-softmax oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.config import QuantConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    chunk_size: int = 64


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # Ratio of mLSTM to sLSTM blocks inside each scanned super-block.
    mlstm_per_block: int = 1
    slstm_per_block: int = 1
    chunk_size: int = 64
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | encoder | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    mlp_type: str = "swiglu"  # swiglu | gelu | squared_relu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | non_parametric
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 0  # zamba2: shared attention block every N ssm layers
    # Execution knobs
    parallelism: str = "tp"  # tp (Megatron TP+DP+SP) | dp_only (pure DP+ZeRO)
    attention_impl: str = "systolic"  # systolic | pallas | naive
    exp2_impl: str = "exact"  # exact | pwl (paper-faithful numerics)
    attn_block_q: int = 128
    attn_block_k: int = 128
    dtype: str = "bfloat16"
    remat: bool = True
    # int8 quantization policy (repro_torch.quant): which layer classes run
    # integer-domain matmuls and whether the KV cache stores int8.  None
    # means fully full-precision (the default everywhere).
    quant: Optional[QuantConfig] = None
    # Dry-run knobs: XLA's cost_analysis counts while-loop bodies once, so
    # the roofline harness unrolls the attention KV scans fully
    # (attn_unroll) and compiles the layer scan at unroll=1 and unroll=2 to
    # extrapolate exact totals (see launch/dryrun.py).
    scan_unroll: int = 1
    attn_unroll: bool = False
    # Frontend stubs ([audio]/[vlm]): the model consumes precomputed
    # frame/patch embeddings instead of token ids.
    embedding_inputs: bool = False
    logit_softcap: float = 0.0

    @property
    def num_scan_steps(self) -> int:
        """Trip count of the layer scan (for cost extrapolation)."""
        if self.family == "ssm":
            return self.num_layers // 2  # (mLSTM, sLSTM) pairs
        return self.num_layers

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def activation_dtype(self):
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model FLOPs)."""
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # xLSTM
            d_in = d * (self.xlstm.mlstm_per_block and 2 or 2)
            per = 2 * d * 2 * d * 2  # rough in/out projections of both block types
            return emb + L * per
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.mlp_type == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        per_layer = attn + mlp
        if self.moe is not None:
            expert = (3 if self.mlp_type == "swiglu" else 2) * d * self.moe.d_ff_expert
            per_layer = attn + self.moe.num_experts * expert + d * self.moe.num_experts
            if self.moe.dense_residual:
                per_layer += 3 * d * self.d_ff
        if self.family == "hybrid":
            # Mamba2 layers + one shared attention block.
            d_inner = self.ssm.expand * d
            nheads = d_inner // self.ssm.head_dim
            mamba = (
                d * (2 * d_inner + 2 * self.ssm.state_dim + nheads)  # in_proj
                + d_inner * d  # out_proj
                + self.ssm.conv_width * (d_inner + 2 * self.ssm.state_dim)
            )
            shared_attn = attn + 3 * d * self.d_ff
            return emb + L * mamba + shared_attn
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        expert = (3 if self.mlp_type == "swiglu" else 2) * d * self.moe.d_ff_expert
        inactive = (self.moe.num_experts - self.moe.top_k) * expert
        return self.param_count() - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The assigned LM-family shape set (applies to every architecture).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
