"""Architecture registry: full configs + reduced smoke configs + cell rules
(copy of ``repro.configs.registry``)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Union

from repro_torch.quant.config import QuantConfig, parse_quant

from .base import SHAPES, ModelConfig

ARCH_IDS = (
    "qwen3-moe-235b-a22b",
    "arctic-480b",
    "hubert-xlarge",
    "olmo-1b",
    "nemotron-4-15b",
    "qwen2.5-32b",
    "yi-9b",
    "qwen2-vl-7b",
    "zamba2-1.2b",
    "xlstm-125m",
)

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "arctic-480b": "arctic_480b",
    "hubert-xlarge": "hubert_xlarge",
    "olmo-1b": "olmo_1b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2.5-32b": "qwen2_5_32b",
    "yi-9b": "yi_9b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-125m": "xlstm_125m",
}


def _with_quant(
    cfg: ModelConfig, quant: Union[QuantConfig, str, None]
) -> ModelConfig:
    """Overlay a quantization policy (a QuantConfig or a --quant flag)."""
    if quant is None:
        return cfg
    if isinstance(quant, str):
        quant = parse_quant(quant)
    return dataclasses.replace(cfg, quant=quant)


def get_config(
    arch: str, quant: Union[QuantConfig, str, None] = None
) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return _with_quant(mod.CONFIG, quant)


def get_smoke_config(
    arch: str, quant: Union[QuantConfig, str, None] = None
) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return _with_quant(mod.SMOKE_CONFIG, quant)


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, applying the skip rules:
    - encoder-only archs (hubert) have no decode step -> skip decode shapes;
    - long_500k needs sub-quadratic attention -> only hybrid/ssm archs.
    """
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if shape.kind == "decode" and cfg.family == "encoder":
                continue  # no decode step exists
            if shape_name == "long_500k" and cfg.family not in ("hybrid", "ssm"):
                continue  # O(S^2) full attention
            cells.append((arch, shape_name))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if shape.kind == "decode" and cfg.family == "encoder":
                out.append((arch, shape_name, "encoder-only: no decode step"))
            elif shape_name == "long_500k" and cfg.family not in ("hybrid", "ssm"):
                out.append((arch, shape_name, "pure full attention: O(S^2) at 524k"))
    return out
