"""End-to-end driver on the PyTorch port (counterpart of
``examples/train_lm.py``): train a ~100M-param dense LM with the full stack
— SystolicAttention layers (on the card, the CUDA forward and backward
kernels), AdamW + cosine, deterministic data pipeline, async atomic
checkpointing, watchdog — and demonstrate crash-recovery by resuming from
the checkpoint in a fresh trainer.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# ~100M params: 12L x d=768 x ff=3072, vocab 32k, tied embeddings.
CFG_100M = ModelConfig(
    name="demo-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=32000,
    mlp_type="swiglu",
    tie_embeddings=True,
    dtype="float32",
    remat=False,
    attn_block_q=128,
    attn_block_k=128,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    shape = ShapeConfig("demo", args.seq, args.batch, "train")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    tcfg = TrainerConfig(
        total_steps=args.steps,
        # Every 50 steps, as the reference; a shorter run checkpoints at its
        # last step, so the resume below always starts from a checkpoint.
        ckpt_every=min(50, args.steps),
        ckpt_dir=ckpt_dir,
        peak_lr=3e-4,
        warmup_steps=20,
        log_every=10,
    )
    trainer = Trainer(CFG_100M, shape, tcfg, device=args.device)

    print(f"training {CFG_100M.param_count()/1e6:.0f}M params on {args.device}, "
          f"{args.steps} steps, ckpts -> {ckpt_dir}")
    state = trainer.run()
    losses = state["losses"]
    print(f"loss: first {losses[0]:.3f} -> last {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must make progress"

    # Crash-recovery demo: a fresh Trainer resumes from the latest ckpt.
    resumed = Trainer(CFG_100M, shape, dataclasses.replace(tcfg, total_steps=args.steps + 10),
                      device=args.device)
    state2 = resumed.run()
    assert len(state2["losses"]) == 10, "the fresh trainer must resume from the checkpoint"
    print(f"resumed from step {state['step']} -> {state2['step']} OK")


if __name__ == "__main__":
    main()
