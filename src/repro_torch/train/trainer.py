"""Training loop with checkpoint/restart, preemption handling, straggler
watchdog, async checkpointing and deterministic data (counterpart of
``repro.train.trainer``), on one device.

Each step lands in the trainer's metrics registry
(``train_steps_total``/``train_tokens_total`` counters,
``train_step_seconds`` histogram, loss/grad-norm/tokens-per-s gauges, the
per-step MFU against the paper's FSA array) and, when
``TrainerConfig.metrics_jsonl`` is set, as one JSON record per step (the
reference's keys; ``launch/scrape_log.py`` reads them back).  Each step is a
``train_step`` span on the trainer's tracer, which is the ambient one inside
the step, so the step's device spans (``forward`` and ``backward`` a
microbatch, ``optimizer``) reach it; they are flushed after the step's loss
read.  With ``compress_grads`` the gradients go through int8 with error
feedback and the residual is part of the state and of the checkpoint.  With ``mesh`` (a ``DeviceMesh`` over
("data", "model")) the params and the residual are placed per the TP rules
(``repro_torch.dist.sharding``), the optimizer state per ZeRO-1 and each
batch over the data axes, and every step runs under the ambient mesh;
checkpoints hold full tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import DataConfig, make_source
from repro_torch.dist.collectives import full, set_mesh
from repro_torch.dist.fault import PreemptionHandler, StepWatchdog
from repro_torch.dist.sharding import batch_pspec, param_shardings, place, zero1_shardings
from repro_torch.models import init_params
from repro_torch.obs import MFUMeter, Registry, get_tracer, using
from repro_torch.optim import make_optimizer
from repro_torch.optim.grad_compress import init_residual
from repro_torch.optim.schedules import cosine_with_warmup
from .train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "build/repro_torch_ckpt"  # relative: git-ignored at the repo root
    keep: int = 3
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    num_microbatches: int = 1
    log_every: int = 10
    seed: int = 0
    watchdog_factor: float = 10.0
    # int8-compressed gradients with error feedback
    # (repro_torch.optim.grad_compress); adds a residual to the state.
    compress_grads: bool = False
    # One JSON object per step appended to this path (None: no stream).
    metrics_jsonl: Optional[str] = None


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        tcfg: TrainerConfig,
        *,
        token_file: Optional[str] = None,
        hooks: Optional[dict[str, Callable]] = None,
        registry: Optional[Registry] = None,
        tracer=None,  # repro_torch.obs Tracer (default: ambient, usually Null)
        device="cuda",
        mesh=None,  # torch DeviceMesh over ("data", "model"); None: one device
    ):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.data = make_source(cfg, shape, DataConfig(seed=tcfg.seed), token_file)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.mfu = MFUMeter(cfg, self.registry)
        self.watchdog = StepWatchdog(timeout_factor=tcfg.watchdog_factor, registry=self.registry)
        self.preempt = PreemptionHandler(install=False, registry=self.registry)
        self.hooks = hooks or {}
        self._steps_total = self.registry.counter("train_steps_total", "optimizer steps completed")
        self._tokens_total = self.registry.counter("train_tokens_total", "tokens consumed")
        self._h_step = self.registry.histogram("train_step_seconds", "wall time per optimizer step")
        self._g_loss = self.registry.gauge("train_loss", "last step loss")
        self._g_gnorm = self.registry.gauge("train_grad_norm", "last step gradient norm")
        self._g_tok_s = self.registry.gauge("train_tokens_per_s", "throughput of the last step")

        sched = cosine_with_warmup(tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps)
        self.optimizer = make_optimizer(tcfg.optimizer, lr=sched)
        self.step_fn = make_train_step(
            cfg, self.optimizer, num_microbatches=tcfg.num_microbatches,
            compress_grads=tcfg.compress_grads,
        )

    # -- state ------------------------------------------------------------

    def _shard_state(self, state: dict) -> dict:
        """Place params (and the compression residual) per the TP rules and
        the optimizer state per ZeRO-1 when a mesh is given."""
        if self.mesh is None:
            return state
        sh = param_shardings(state["params"], self.cfg, self.mesh)
        out = dict(state)
        out["params"] = place(state["params"], sh)
        out["opt"] = place(state["opt"], zero1_shardings(state["opt"], self.cfg, self.mesh))
        if "residual" in state:
            out["residual"] = place(state["residual"], sh)
        return out

    def init_state(self) -> dict:
        params = init_params(self.cfg, self.tcfg.seed, self.device)
        state = {"params": params, "opt": self.optimizer.init(params), "step": 0}
        if self.tcfg.compress_grads:
            state["residual"] = init_residual(params)
        return self._shard_state(state)

    def restore_or_init(self) -> dict:
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state()
        template = {k: v for k, v in self.init_state().items() if k != "step"}
        restored = self.ckpt.restore(latest, _full_tree(template))
        restored["step"] = latest
        return self._shard_state(restored)

    def _batch(self, step: int) -> dict:
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in self.data.batch(step).items()}
        return batch if self.mesh is None else place(batch, batch_pspec(batch, self.mesh, self.cfg))

    def _save(self, step: int, tree: dict, wait: bool = True) -> None:
        """Checkpoint full tensors (a collective gather under a mesh); one
        rank writes."""
        tree = _full_tree(tree)
        if self.mesh is not None and self.mesh.get_rank() != 0:
            return
        self.ckpt.save(step, tree) if wait else self.ckpt.save_async(step, tree)

    # -- loop --------------------------------------------------------------

    def run(self, state: Optional[dict] = None) -> dict:
        """Step ``state`` (default: the latest checkpoint, else fresh
        params) up to ``total_steps``; returns it with ``losses``."""
        state = state or self.restore_or_init()
        ckpt_keys = ("params", "opt") + (("residual",) if self.tcfg.compress_grads else ())
        losses = []
        tokens_per_batch = self.shape.global_batch * self.shape.seq_len
        jsonl_path = self.tcfg.metrics_jsonl
        with open(jsonl_path, "a") if jsonl_path else contextlib.nullcontext() as jsonl:
            while state["step"] < self.tcfg.total_steps:
                if self.preempt.requested:
                    self._save(state["step"], {k: state[k] for k in ckpt_keys})
                    break
                step = state["step"]
                batch = self._batch(step)
                self.watchdog.start_step()
                with set_mesh(self.mesh), using(self.tracer), \
                        self.tracer.span("train_step", cat="train", tid=0, args={"step": step}):
                    if self.tcfg.compress_grads:
                        params, opt, residual, metrics = self.step_fn(
                            state["params"], state["opt"], batch, state["residual"]
                        )
                        new_state = {"params": params, "opt": opt, "residual": residual, "step": step + 1}
                    else:
                        params, opt, metrics = self.step_fn(state["params"], state["opt"], batch)
                        new_state = {"params": params, "opt": opt, "step": step + 1}
                    loss = full(metrics["loss"]).item()  # waits for the step, as block_until_ready
                dur = self.watchdog.end_step()
                self.tracer.flush()
                state = new_state
                gnorm = full(metrics["grad_norm"]).item()
                losses.append(loss)
                self._steps_total.inc()
                self._tokens_total.inc(tokens_per_batch)
                self._h_step.observe(dur)
                self._g_loss.set(loss)
                self._g_gnorm.set(gnorm)
                self._g_tok_s.set(tokens_per_batch / dur)
                mfu_rec = self.mfu.train_step(self.shape.global_batch, self.shape.seq_len, dur)
                if jsonl is not None:
                    jsonl.write(json.dumps({
                        "event": "train_step",
                        "step": step + 1,
                        "loss": loss,
                        "grad_norm": gnorm,
                        "step_s": dur,
                        "tokens_per_s": tokens_per_batch / dur,
                        "mfu": mfu_rec["mfu"],
                        "model_flops_per_s": mfu_rec["flops_per_s"],
                    }) + "\n")
                    jsonl.flush()
                if "on_step" in self.hooks:
                    self.hooks["on_step"](state, metrics)
                if (step + 1) % self.tcfg.log_every == 0:
                    print(f"step {step + 1} loss {loss:.4f} gnorm {gnorm:.3f} {dur * 1e3:.0f} ms")
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self._save(step + 1, {k: state[k] for k in ckpt_keys}, wait=False)
        self.ckpt.wait()
        state["losses"] = losses
        return state


def _full_tree(tree):
    """A state tree with its DTensor leaves gathered to full tensors."""
    if isinstance(tree, dict):
        return {k: _full_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_full_tree(v) for v in tree))
    return full(tree)
