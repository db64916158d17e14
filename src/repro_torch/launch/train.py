"""Training launcher (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --steps 4 --batch 2 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 6 \
      --batch 4 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --steps 6 \
      --batch 4 --seq 2048

``--smoke`` uses the arch's reduced config; without it the full config
trains (on the card: full-width olmo-1b peaked at 41.48 GB at batch 4 x
2048, remat, AdamW).  The weights are random, from the trainer's seed; the data is the
seeded synthetic stream unless ``--token-file`` names a corpus.  A run
resumes from the latest checkpoint in ``--ckpt-dir``.

  --device           cuda (default) or cpu
  --quant int8       int8 projections (quantization-aware: the backward is
                     straight-through); the flags of repro_torch.quant
  --compress-grads   int8 gradients with error feedback
  --metrics-out PATH Prometheus text dump at exit (loss/gnorm gauges,
                     step-latency histogram, MFU against the paper's FSA
                     array, watchdog heartbeats); also streams one JSON
                     record per step to PATH.jsonl (launch/scrape_log.py
                     reads it)
  --trace-out PATH   Chrome-trace/Perfetto JSON of the per-step spans

  --mesh DxM         debug mesh (data x model), e.g. --mesh 2x1: params per
                     the TP rules, optimizer state per ZeRO-1, batches over
                     "data".  D*M > 1 runs under
                     torchrun --standalone --nproc-per-node D*M (gloo with
                     --device cpu, NCCL on the card); --mesh 1x1 makes a
                     world-size-1 group where none exists.

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch olmo-1b --smoke --steps 2 \
      --batch 4 --seq 32 --device cpu --mesh 2x1
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.obs import Tracer, set_tracer
from repro_torch.quant.config import QUANT_FLAGS
from repro_torch.train.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--token-file", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quant", default="none", choices=QUANT_FLAGS)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8-compressed gradients with error feedback")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="Prometheus dump at exit + per-step PATH.jsonl stream")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace here")
    ap.add_argument("--mesh", default=None, help="debug mesh DxM, e.g. 2x1")
    args = ap.parse_args()

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch, args.quant)
    if cfg.family == "encoder" and not cfg.embedding_inputs:
        raise SystemExit("encoder archs train on frame embeddings")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh, made_group = None, False
    if args.mesh:
        from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh, parse_mesh

        data, model = parse_mesh(args.mesh)
        made_group = ensure_process_group(data * model, args.device)
        mesh = make_debug_mesh(data, model, device_type=args.device)
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    lead = mesh is None or mesh.get_rank() == 0  # one rank reports
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        optimizer=args.optimizer,
        peak_lr=args.lr,
        num_microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        log_every=max(args.steps // 10, 1),
        metrics_jsonl=args.metrics_out + ".jsonl" if args.metrics_out and lead else None,
    )
    tracer = None
    if args.trace_out:
        tracer = Tracer(process_name=f"train {args.arch}")
        set_tracer(tracer)
    trainer = Trainer(cfg, shape, tcfg, token_file=args.token_file, tracer=tracer, device=args.device,
                      mesh=mesh)
    try:
        state = trainer.run()
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()
    if not lead:
        return
    if state["losses"]:
        print(f"done at step {state['step']} on {args.device}; "
              f"loss {state['losses'][0]:.4f} -> {state['losses'][-1]:.4f}")
        mfu = trainer.registry.get("mfu").labels(phase="train").value
        print(f"mfu (train, against the paper's FSA array peak, not the card's): {mfu:.3e}")
    else:
        print(f"nothing to do: {args.ckpt_dir} is at step {state['step']}")
    if args.metrics_out:
        trainer.registry.dump(args.metrics_out)
        print(f"metrics -> {args.metrics_out} (+ {tcfg.metrics_jsonl})")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace ({len(tracer.events)} events) -> {args.trace_out}")


if __name__ == "__main__":
    main()
