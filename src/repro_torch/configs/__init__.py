from .base import SHAPES, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, XLSTMConfig  # noqa: F401
from .registry import ARCH_IDS, get_config, get_smoke_config, runnable_cells, skipped_cells  # noqa: F401
