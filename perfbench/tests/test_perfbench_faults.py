"""A run with the timed path broken underneath comes out not correct, once
for each fault its cell can have; the run itself, without the look for a
card, on tiny float32 models on the CPU."""

import pytest
import torch

from perfbench.tests import tiny  # noqa: I001  (sets up the import paths first)
from perfbench import run as entry
from perfbench.harness import train


def _correct(cell, seed=5):
    return entry.run_cell(cell, seed, 0.5, False, device="cpu")["correct"]


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_sound_serving_runs_are_correct(model):
    assert _correct(tiny.cell(model))


def test_sound_training_run_is_correct():
    assert _correct(tiny.cell(tiny.DENSE, tiny.TRAIN))


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_a_token_altered_where_it_is_produced(model, monkeypatch):
    from repro_torch.serve import engine, serve_step

    original = serve_step.sample_logits

    def altered(logits, generator, scfg):
        tok = original(logits, generator, scfg)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(serve_step, "sample_logits", altered)
    monkeypatch.setattr(engine, "sample_logits", altered)
    assert not _correct(tiny.cell(model))


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_a_prefill_that_leaves_the_decode_state_unchanged(model, monkeypatch):
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, "insert_cache", lambda cache, prefix, slot: cache)
    assert not _correct(tiny.cell(model))


def test_fewer_finished_requests_than_the_check_asks_for():
    assert not _correct(tiny.cell(tiny.DENSE, check={"requests": 10**4}))


def test_a_training_step_that_returns_its_state_unchanged(monkeypatch):
    make = train.make_trainer

    def frozen(*args, **kw):
        trainer = make(*args, **kw)
        step = trainer.step_fn

        def unchanged(params, opt, batch):
            _, _, metrics = step(params, opt, batch)
            return params, opt, metrics

        trainer.step_fn = unchanged
        return trainer

    monkeypatch.setattr(train, "make_trainer", frozen)
    assert not _correct(tiny.cell(tiny.DENSE, tiny.TRAIN))


def test_half_of_the_batch_left_out(monkeypatch):
    whole = train.SeededBatches.batch
    monkeypatch.setattr(train.SeededBatches, "batch",
                        lambda self, step: {k: v[: v.shape[0] // 2] for k, v in whole(self, step).items()})
    assert not _correct(tiny.cell(tiny.DENSE, tiny.TRAIN))


def test_the_trainer_runs_as_the_configuration_states(monkeypatch):
    c = tiny.cell(tiny.DENSE, tiny.TRAIN)
    c.traffic["optimizer"]["b2"] = 0.999
    with pytest.raises(SystemExit):
        entry.run_cell(c, 5, 0.5, False, device="cpu")
    assert torch.is_grad_enabled()


@pytest.mark.parametrize("traffic", [tiny.SERVE, tiny.TRAIN], ids=["serve", "train"])
def test_a_traced_run_reads_its_per_layer_metrics(traffic):
    from perfbench.harness import bench

    c = tiny.cell(tiny.DENSE, traffic, trace_s=1.5)
    names = ({"slot_occupancy.open", "decode_step_ms", "prefill_ms_per_ktok", "queue_wait_ms_p95", "mfu.serve"}
             if traffic is tiny.SERVE else {"mfu.train"})
    c.per_layer = [m for m in bench.benchmark()["per_layer"] if m["name"] in names]
    out = entry.run_cell(c, 5, 3.0, True, device="cpu")
    assert out["correct"] and out["window_s"] > 0, out["checks"]
    assert set(out["metrics"]) == names
