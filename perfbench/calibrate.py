"""Readings that the output check's limits are set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload olmo-1b.serve.chat --seeds 11 12 13 --seconds 10 --control 3

For each seed, in one process on one card: the cell's own run (a short
window at the cell's load) and the numbers its check compares; for the
first ``--control`` seeds also the control, the nearest lower precision
than the configuration's bf16, through the program's own int8 path
(``--quant int8``: int8 weights and activations, int8 KV cache):

  * serving: the program's int8 path over the same prompts and served
    tokens, routed as they were served: ``prefill_step`` over the prompt
    padded to its bucket (MoE capacity over the bucket), then
    ``verify_step`` teacher-forcing the served tokens against that cache
    (dropless MoE; each row what a decode step would give).  At each
    position the gap in the float32 reference's logits of the token int8
    puts first;
  * training: the program's trainer under int8 for the checked steps from
    the same weights and batches, and a fault, half of each batch left out
    (the loss then a mean over the rest), each held to the reference.

One JSON line per seed and reading.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.run import _environment  # noqa: E402

_environment()

import torch  # noqa: E402

from perfbench.harness import bench, check, profiling, serve, train, weights  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402


def int8(cfg):
    from repro_torch.quant.config import QuantConfig

    return dataclasses.replace(cfg, quant=QuantConfig())


VERIFY_ROWS = 512  # served tokens teacher-forced per verify call


@torch.no_grad()
def served_argmax(cfg, params, traffic: dict, prompt, out) -> torch.Tensor:
    """The token that the program under ``cfg`` puts first at each position
    that predicts a served token of ``out``, teacher-forced over ``prompt``
    and ``out`` and routed as serving routes them."""
    import numpy as np
    from repro_torch.models.model import init_cache, prefill_step, verify_step

    device = params["embed"].device
    plen, n = len(prompt), len(out)
    toks = np.zeros((1, serve.bucket_for(traffic, plen)), np.int32)
    toks[0, :plen] = prompt
    cache = init_cache(cfg, 1, traffic["engine"]["max_len"], device=device)
    logits, cache = prefill_step(params, cfg, torch.as_tensor(toks, device=device), cache, [plen])
    pred = [logits[0, plen - 1:plen].float().argmax(-1)]
    forced = torch.as_tensor(np.asarray(out[:-1], np.int32), device=device)
    for start in range(0, n - 1, VERIFY_ROWS):
        rows = forced[None, start:start + VERIFY_ROWS]
        logits, cache = verify_step(params, cfg, rows, cache, torch.tensor([plen + start], device=device))
        pred.append(logits[0].float().argmax(-1))
    return torch.cat(pred)


def serve_control(cell, params, samples) -> dict:
    """The reference-logit gaps (``check.summarize_gaps``) of the tokens the
    program's int8 path puts first, over the sampled prompts and served
    tokens [(prompt, served tokens)]."""
    cfg8 = int8(bench.model_config(cell.model))
    parts = []
    for prompt, out in samples:
        pred = served_argmax(cfg8, params, cell.traffic, prompt, out)
        ref = check.reference_logits(params, cell.model, prompt, out, lambda n: serve.bucket_for(cell.traffic, n))
        parts.append(check.gaps(ref, pred))
    return check.summarize_gaps(parts)


class HalfBatches(train.SeededBatches):
    """A fault: the first half of each batch's rows only."""

    def batch(self, step: int) -> dict:
        b = super().batch(step)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()}


def train_readings(cell, seed: int, device) -> dict:
    tr, opt = cell.traffic, cell.traffic["optimizer"]
    params = weights.make(cell.model, seed, device)
    start_host = {k: v.cpu() for k, v in ref_train.flatten(params).items()}
    layout = ref_train.layout(params)
    del params
    reference = train.reference_numbers(cell, seed, start_host, layout, device)
    out = {}
    cfg = bench.model_config(cell.model)
    for name, c, source in (("int8", int8(cfg), None), ("half_batch", cfg, HalfBatches)):
        trainer = train.make_trainer(cell, c, seed, device)
        if source is not None:
            trainer.data = source(cfg.vocab_size, tr["batch"], tr["seq_len"], seed)
        state, numbers = train.first_steps(trainer, start_host, layout, tr["warmup_steps_run"], opt)
        del state, trainer
        profiling.free()
        out[name] = check.train_numbers(numbers, reference)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also run the control")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    is_train = cell.traffic["loop"] == "train"
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run, numbers, peak, _, _ = (train if is_train else serve).run(cell, seed, args.seconds, False, "cuda", t0)
        line = {"seed": seed, "program": numbers, "memory_peak_bytes": peak, "seconds": time.perf_counter() - t0}
        if i < args.control:
            t1 = time.perf_counter()
            if is_train:
                line.update(train_readings(cell, seed, "cuda"))
            else:
                line["int8"] = serve_control(cell, weights.make(cell.model, seed, "cuda"), run.samples)
            line["control_seconds"] = time.perf_counter() - t1
        print(json.dumps(line), flush=True)
        del run
        profiling.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
