"""The control, the configuration's precision lowered to the program's own
int8 path, fails the output check, here at a size a test run can hold (the
cells' readings on the card are in PERF.md)."""

import numpy as np
import pytest

from perfbench.tests import tiny  # noqa: I001  (sets up the import paths first)
from perfbench import calibrate
from perfbench.harness import bench, check, generate, serve, weights


def _served(cell, seed: int, n: int):
    """``n`` requests of the cell's mix served to the end by the engine (no
    clock involved): the weights and the (prompt, served tokens) pairs."""
    from repro_torch.serve import Request, SamplingConfig, ServeEngine

    eng = cell.traffic["engine"]
    params = weights.make(cell.model, seed, "cpu")
    engine = ServeEngine(bench.model_config(cell.model), params, batch_size=eng["batch_size"],
                         max_len=eng["max_len"], prefill_buckets=tuple(eng["prefill_buckets"]),
                         sampling=SamplingConfig(), device="cpu")
    stream = generate.Requests(cell.traffic, cell.model["vocab_size"], seed)
    for rid in range(n):
        prompt, max_new, _ = stream.next()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    done = sorted(engine.run(), key=lambda r: r.rid)
    return params, [(r.prompt, np.asarray(r.output, np.int64)) for r in done]


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_control_path_at_the_served_precision_gives_the_served_tokens(model):
    """The control changes the precision and nothing else: at the
    configuration's own precision its prefill and teacher-forced verify,
    routed as serving routes, put first every token the engine served."""
    cell = tiny.cell(model)
    params, samples = _served(cell, 9, 12)
    cfg = bench.model_config(cell.model)
    for prompt, out in samples:
        pred = calibrate.served_argmax(cfg, params, cell.traffic, prompt, out)
        assert pred.tolist() == out.tolist()


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_int8_serving_fails_the_logit_gap(model):
    cell = tiny.cell(model)
    params, samples = _served(cell, 9, 12)
    numbers = check.served_logit_gaps(params, cell.model, samples, lambda n: serve.bucket_for(cell.traffic, n))
    control = calibrate.serve_control(cell, params, samples)
    assert numbers["logit_gap"] <= cell.limits["logit_gap"] < control["logit_gap"]
    assert numbers["argmax_mismatch"] < control["argmax_mismatch"]


def test_int8_training_and_half_batches_fail():
    cell = tiny.cell(tiny.DENSE, tiny.TRAIN)
    readings = calibrate.train_readings(cell, 9, "cpu")
    for name in ("int8", "half_batch"):
        assert any(readings[name][k] > lim for k, lim in cell.limits.items()), (name, readings[name])
