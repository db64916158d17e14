"""Where a training step's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train
  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch zamba2-1.2b

A full-width model (default olmo-1b) in bf16 (remat, AdamW with a cosine
schedule) with seeded random weights at ``chip_smoke.py``'s training shape
(batch 4 x 2048 of SyntheticLM, seed 0; xlstm-125m at its cut, 2 x 256).
For one training step, its loss and gradients
alone, and the optimizer update alone, one JSON line each (the helpers of
``profile_serve``): host wall ms (median of its repeats, each ended by a
synchronize), device ms of one ``torch.profiler`` trace, the device's busy
share, the share of each attention kernel, and the kernels that take the
most device time.  Needs the card.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import DataConfig, make_source
from repro_torch.models import init_params
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train.train_step import make_train_step, value_and_grad

from .profile_serve import FORWARD_GROUPS, report

SHAPE = ShapeConfig("profile_train", 2048, 4, "train")  # chip_smoke.py's train phase
# xlstm-125m's per-token loops under autograd: chip_smoke.py's recurrent phase's cut.
SHAPES = {"xlstm-125m": ShapeConfig("profile_train", 256, 2, "train")}
GROUPS = {**FORWARD_GROUPS, "flash_bwd_sm90_dq": "flash_bwd_sm90_dq_kernel",
          "flash_bwd_sm90_dkv": "flash_bwd_sm90_dkv_kernel"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card; no CUDA device found")

    cfg = get_config(args.arch)
    shape_cfg = SHAPES.get(args.arch, SHAPE)
    params = init_params(cfg, 0, device="cuda")
    optimizer = AdamW(lr=cosine_with_warmup(3e-4, 2, 6))  # chip_smoke.py's train phase
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, optimizer)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in make_source(cfg, shape_cfg, DataConfig(seed=0)).batch(0).items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "arch": cfg.name,
                      "dtype": cfg.dtype, "remat": cfg.remat}), flush=True)
    shape = dict(batch=shape_cfg.global_batch, seq=shape_cfg.seq_len)

    # Each call's results are dropped: params and state stay as they are.
    report("train_step", lambda: step(params, opt_state, batch), 1, groups=GROUPS, **shape)
    report("loss_and_grads", lambda: value_and_grad(cfg, params, batch), 1, groups=GROUPS, **shape)
    _, grads = value_and_grad(cfg, params, batch)
    report("optimizer_update", lambda: optimizer.update(grads, opt_state, params), 1)


if __name__ == "__main__":
    main()
