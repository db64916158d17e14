"""repro_torch.tune — device-sharded FSA design-space autotuner (counterpart
of ``repro.tune``).

The paper publishes one design point (128x128 array, dual-direction
schedule, 8-segment PWL exp2, 192+64 KiB SRAM, 1.5 GHz); this subsystem
explores the whole space around it:

  * ``design``     — frozen, hashable ``DesignPoint`` with Table 1
                     capacity validation;
  * ``objectives`` — utilization/TFLOPs (systolic_model closed forms),
                     Table 2 accuracy (fsa_sim-equivalent vectorized
                     numerics) and Table 3 area, each cross-checked
                     against the paper's numbers at the paper's point;
                     the Fig. 12 PWL sweep runs through the PWL exp2
                     kernel on the card;
  * ``search``     — grid sweep sharded over the local devices (torch),
                     random search, successive halving (deterministic
                     seeding);
  * ``pareto``     — non-dominated frontier over (TFLOP/s, area, error);
  * ``report``     — ``run_tune`` + markdown / JSON output
                     (``python -m repro_torch.launch.tune``).

Everything takes ``device`` (default ``"cuda"``); the tests pass ``"cpu"``.
"""

from .design import (  # noqa: F401
    DesignPoint,
    accum_required_bytes,
    exact_fit_point,
    paper_point,
    spad_required_bytes,
)
from .objectives import (  # noqa: F401
    PAPER_TARGETS,
    eval_accuracy,
    eval_area,
    eval_performance,
    evaluate,
    quantized_systolic_attention,
)
from .pareto import OBJECTIVES, dominates, pareto_front  # noqa: F401
from .report import PRESETS, render_markdown, run_tune, write_report  # noqa: F401
from .search import (  # noqa: F401
    SweepResult,
    encode_points,
    grid_space,
    grid_sweep,
    random_search,
    scalar_score,
    successive_halving,
    tune_mesh,
)

__all__ = [
    "DesignPoint", "paper_point", "exact_fit_point",
    "spad_required_bytes", "accum_required_bytes",
    "PAPER_TARGETS", "evaluate", "eval_performance", "eval_accuracy",
    "eval_area", "quantized_systolic_attention",
    "OBJECTIVES", "pareto_front", "dominates",
    "SweepResult", "tune_mesh", "encode_points", "grid_space", "grid_sweep",
    "random_search", "successive_halving", "scalar_score",
    "PRESETS", "run_tune", "render_markdown", "write_report",
]
