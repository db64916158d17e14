"""repro_torch.dist: the distributed-execution substrate (counterpart of
``repro.dist``), on ``torch.distributed`` device meshes and DTensors.

  * ``collectives``: the ambient mesh (``set_mesh``), ``constrain``,
    ``psum_mean`` and ``local_island`` (the reference's shard_map);
  * ``sharding``: path-based TP/DP/SP partition rules over the
    ("pod", "data", "model") mesh: params, optimizer state (ZeRO-1),
    batches and KV caches, and ``place``;
  * ``elastic``: mesh rescale plans with divisibility validation;
  * ``fault``: step watchdog, preemption drain and restart loop;
  * ``pipeline``: GPipe over the "pod" axis (``pipelined_apply``), its
    activations passed between stages by point-to-point ops.
"""

from .collectives import constrain, set_mesh  # noqa: F401
from .elastic import RescalePlan, apply_rescale, rescale_plan  # noqa: F401
from .fault import (  # noqa: F401
    PreemptionHandler,
    StepWatchdog,
    StragglerDetected,
    run_with_restarts,
)
from .pipeline import pipelined_apply  # noqa: F401
from .sharding import (  # noqa: F401
    batch_pspec,
    cache_shardings,
    param_pspec,
    param_shardings,
    place,
    zero1_shardings,
)
