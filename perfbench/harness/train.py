"""A training run: ``repro_torch.train.trainer.Trainer.run`` on a state
this benchmark made, fed the seeded batches through the trainer's data
source, with checkpoints off.

Set-up makes the weights from the seed, keeps a host copy of them for the
reference, and runs the first ``warmup_steps_run`` steps through
``Trainer.run`` itself: they build and load the kernels and are the steps
the output check follows (the losses, the gradient as AdamW got it at step
1, read from its first moment, and the change of the weights over the
first three steps).  The same trainer and state then run the window: steps
back to back until the first step that ends ``--seconds`` after the window
opened, stopped through ``hooks["on_step"]``; the window closes at that
step's end.  A traced run profiles the steps that start in the window's
last ``trace_s`` seconds.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.obs import NullTracer, Tracer
from repro_torch.train.trainer import Trainer, TrainerConfig

from perfbench.reference import train as ref_train

from . import bench, check, generate, profiling, weights
from .record import Run, Step


class SeededBatches:
    """The trainer's data source: ``batch(step)`` from the run's seed."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int):
        self.args = (vocab, batch, seq_len, seed)

    def batch(self, step: int) -> dict:
        return generate.train_batch(*self.args, step)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in ref_train.flatten(tree).items()}


def make_trainer(cell: bench.Cell, cfg, seed: int, device, tracer=None) -> Trainer:
    """The program's trainer at the configuration's AdamW, fed the seeded
    batches, checkpoints off."""
    tr, opt = cell.traffic, cell.traffic["optimizer"]
    trainer = Trainer(
        cfg, ShapeConfig("perfbench", tr["seq_len"], tr["batch"], "train"),
        TrainerConfig(total_steps=opt["total_steps"], peak_lr=opt["peak_lr"], warmup_steps=opt["warmup_steps"],
                      ckpt_every=10**9, ckpt_dir=str(bench.ROOT / "build" / "perfbench_ckpt"),
                      log_every=10**9, seed=seed),
        tracer=tracer or NullTracer(), device=device,
    )
    got = (trainer.optimizer.b1, trainer.optimizer.b2, trainer.optimizer.eps, trainer.optimizer.weight_decay)
    if got != (opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]):
        raise SystemExit(f"the trainer's AdamW {got} is not the configuration's {opt}")
    trainer.data = SeededBatches(cfg.vocab_size, tr["batch"], tr["seq_len"], seed)
    return trainer


class FirstSteps:
    """What the output check reads of the program's first steps: each
    step's loss, each leaf's gradient as AdamW got it at step 1 (its first
    moment over 1 - b1) and each leaf's change over ``n`` steps."""

    def __init__(self, start_host: dict, b1: float, n: int):
        self.start_host, self.b1, self.n = start_host, b1, n
        self.numbers = {"losses": []}

    def __call__(self, state, metrics) -> None:
        step = state["step"]
        self.numbers["losses"].append(float(metrics["loss"]))
        if step == 1:
            grads = {k: v / (1 - self.b1) for k, v in ref_train.flatten(state["opt"].m).items()}
            self.numbers["grad"] = _norms(grads)
            self.numbers["grad_t"] = {k: v.cpu() for k, v in grads.items()}
        if step == self.n:
            self.numbers["change"] = _norms({k: v.float() - self.start_host[k].to(v.device).float()
                                             for k, v in ref_train.flatten(state["params"]).items()})


def first_steps(trainer: Trainer, start_host: dict, layout: dict, n: int, opt: dict):
    """Runs the program's first ``n`` steps from ``start_host`` through
    ``Trainer.run``; (state, the numbers the check reads)."""
    device = trainer.device
    params = ref_train.unflatten({k: v.to(device) for k, v in start_host.items()}, layout)
    record = FirstSteps(start_host, opt["b1"], n)
    trainer.hooks["on_step"] = record
    trainer.tcfg.total_steps = n
    state = trainer.run({"params": params, "opt": trainer.optimizer.init(params), "step": 0})
    return state, record.numbers


def reference_numbers(cell: bench.Cell, seed: int, start_host: dict, layout: dict, device) -> dict:
    tr = cell.traffic
    start = ref_train.unflatten({k: v.to(device) for k, v in start_host.items()}, layout)
    batches = [generate.train_batch(cell.model["vocab_size"], tr["batch"], tr["seq_len"], seed, s)
               for s in range(tr["warmup_steps_run"])]
    batches = [(torch.as_tensor(b["tokens"], device=device), torch.as_tensor(b["labels"], device=device))
               for b in batches]
    return ref_train.run_steps(start, cell.model, batches, tr["optimizer"])


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device, t_process: float):
    tr, opt = cell.traffic, cell.traffic["optimizer"]
    cfg = bench.model_config(cell.model)
    batch, seq_len = tr["batch"], tr["seq_len"]
    params = weights.make(cell.model, seed, device)
    start_host = {k: v.cpu() for k, v in ref_train.flatten(params).items()}
    layout = ref_train.layout(params)
    del params
    tracer = Tracer(process_name="perfbench") if trace else NullTracer()
    trainer = make_trainer(cell, cfg, seed, device, tracer)
    state, program = first_steps(trainer, start_host, layout, tr["warmup_steps_run"], opt)

    steps: list[Step] = []
    capture = profiling.Capture() if trace else None
    clock = {}

    def on_step(state, metrics):
        step, now = state["step"], time.perf_counter()
        steps.append(Step(clock["last"], now, batch * seq_len))
        clock["last"] = now
        if now >= clock["close"]:
            trainer.tcfg.total_steps = step
            if capture is not None and capture.running:
                capture.stop()
        elif capture is not None and capture.prof is None and now >= clock["close"] - tr["trace_s"]:
            capture.start()

    trainer.hooks["on_step"] = on_step
    w_open = clock["last"] = time.perf_counter()
    clock["close"] = w_open + seconds
    trainer.tcfg.total_steps = 10**9
    state = trainer.run(state)
    if capture is not None and capture.running:
        capture.stop()
    w_close = steps[-1].t_end
    run = Run(kind="train", model=cell.model, traffic=tr, window=(w_open, w_close), setup_s=w_open - t_process,
              steps=steps)
    if trace:
        run.trace = capture.reduce() if capture.t0 is not None else None
        run.trace_t0, run.trace_t1 = capture.t0, capture.t1
        epoch = tracer._epoch
        run.spans = [(e["name"], epoch + e["ts"] / 1e6, epoch + (e["ts"] + e["dur"]) / 1e6, e.get("args", {}))
                     for e in tracer.events if e.get("ph") == "X"]
    memory_peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0

    # The output check, once the program's state is freed.
    del state, trainer
    profiling.free()
    reference = reference_numbers(cell, seed, start_host, layout, device)
    return run, check.train_numbers(program, reference), memory_peak, len(steps), 0
