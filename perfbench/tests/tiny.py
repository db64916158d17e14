"""Tiny cells for the CPU tests: the benchmark's own traffic loops and
checks on small float32 models of the two families."""

from __future__ import annotations

import copy

from perfbench import run as entry

entry._environment()

from perfbench.harness import bench  # noqa: E402

DENSE = {"name": "tiny-dense", "family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 4, "head_dim": 16, "d_ff": 128, "vocab_size": 256, "mlp_type": "swiglu",
         "norm_type": "non_parametric", "tie_embeddings": True, "rope_theta": 10000.0,
         "dtype": "float32", "remat": True}
MOE = {"name": "tiny-moe", "family": "moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 256, "mlp_type": "swiglu",
       "norm_type": "rmsnorm", "qk_norm": True, "rope_theta": 1000000.0, "dtype": "float32", "remat": True,
       "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32, "capacity_factor": 1.25}}
SERVE = {"loop": "open", "rate_per_s": 40.0, "block": 8,
         "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.8, "min": 4, "max": 30},
         "output": {"dist": "lognormal", "median": 6, "sigma": 0.7, "min": 2, "max": 12},
         "engine": {"batch_size": 4, "max_len": 48, "prefill_buckets": [8, 16, 32]},
         "ramp_s": 0.3, "trace_s": 0.5, "check": {"requests": 8}}
TRAIN = {"loop": "train", "batch": 2, "seq_len": 16, "warmup_steps_run": 3, "trace_s": 0.5,
         "optimizer": {"peak_lr": 3e-4, "warmup_steps": 10, "total_steps": 100, "b1": 0.9, "b2": 0.95,
                       "eps": 1e-8, "weight_decay": 0.1}}
SERVE_LIMITS = {"logit_gap": 1e-3, "missing_first_tokens": 0, "short_outputs": 0, "unchecked_samples": 0}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}


def cell(model=DENSE, traffic=SERVE, limits=None, **changes) -> bench.Cell:
    traffic = {**copy.deepcopy(traffic), **changes}
    if limits is None:
        limits = TRAIN_LIMITS if traffic["loop"] == "train" else SERVE_LIMITS
    return bench.Cell(name="tiny", chips=1, config_name=model["name"], model=copy.deepcopy(model), config_file={},
                      traffic_name="tiny", traffic=traffic, limits=dict(limits), end_to_end=[], per_layer=[])


def run(c: bench.Cell, seed: int = 3, seconds: float = 0.5):
    """One run on the CPU: the loop's (run, checks, ...) tuple."""
    from perfbench.harness import serve, train

    loop = train if c.traffic["loop"] == "train" else serve
    import time

    return loop.run(c, seed, seconds, False, "cpu", time.perf_counter())
