"""The readers of the program's device spans: each on hand-built runs
(spans in and out of the window, none at all), each registered and found
by name, and each read off a traced run of a tiny cell on the CPU, where a
device span is its host interval."""

import time

import pytest

from perfbench.tests import tiny  # noqa: I001  (sets up the import paths first)
from perfbench.harness import bench, serve, train
from perfbench.harness.record import Run

READERS = {"decode_attention_ms": "olmo-1b.serve.chat", "decode_device_ms": "olmo-1b.serve.chat",
           "train_forward_ms": "olmo-1b.train.pretrain", "train_backward_ms": "olmo-1b.train.pretrain",
           "train_optimizer_ms": "olmo-1b.train.pretrain"}


def _run(kind, spans):
    return Run(kind=kind, model={}, traffic={}, window=(10.0, 20.0), setup_s=0.0, spans=spans)


SERVE_SPANS = [
    ("generate", 9.4, 9.8, {"live": 2}), ("decode_step", 9.5, 9.7, {}), ("decode_attention", 9.5, 9.6, {}),
    ("generate", 10.9, 11.3, {"live": 2}), ("decode_step", 11.0, 11.2, {}),
    ("decode_attention", 11.0, 11.05, {}), ("decode_attention", 11.1, 11.15, {}),
    ("generate", 11.9, 12.4, {"live": 2}), ("decode_step", 12.0, 12.3, {}),
    ("decode_attention", 12.0, 12.1, {}), ("decode_attention", 12.1, 12.2, {}),
    ("decode_step", 20.0, 20.1, {}), ("decode_attention", 20.0, 20.05, {}),  # the window is [open, close)
]
TRAIN_SPANS = [
    ("train_step", 9.0, 10.0, {"step": 0}), ("forward", 9.1, 9.2, {}), ("backward", 9.2, 9.6, {}),
    ("optimizer", 9.6, 9.7, {}),
    ("train_step", 10.5, 11.5, {"step": 1}), ("forward", 10.6, 10.7, {}), ("backward", 10.7, 11.0, {}),
    ("forward", 11.0, 11.1, {}), ("backward", 11.1, 11.3, {}), ("optimizer", 11.3, 11.4, {}),
    ("train_step", 11.5, 12.5, {"step": 2}), ("forward", 11.6, 11.8, {}), ("backward", 11.8, 12.1, {}),
    ("forward", 12.1, 12.2, {}), ("backward", 12.2, 12.3, {}), ("optimizer", 12.3, 12.35, {}),
]
EXPECTED = {
    "decode_attention_ms": (SERVE_SPANS, 0.3e3 / 2),
    "decode_device_ms": (SERVE_SPANS, 0.5e3 / 2),
    "train_forward_ms": (TRAIN_SPANS, 0.5e3 / 2),
    "train_backward_ms": (TRAIN_SPANS, 0.9e3 / 2),
    "train_optimizer_ms": (TRAIN_SPANS, 0.15e3 / 2),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_on_hand_built_spans(metric):
    spans, want = EXPECTED[metric]
    read = bench.reader(metric)
    assert read(_run("serve", spans)) == pytest.approx(want)
    assert read(_run("serve", [])) is None
    assert read(_run("serve", [s for s in spans if not 10.0 <= s[1] < 20.0])) is None
    # The parent's spans alone (no device spans) read nothing.
    host_only = [s for s in spans if s[0] in ("generate", "train_step")]
    assert read(_run("serve", host_only)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_registered_and_found(metric):
    (entry,) = [m for m in bench.benchmark()["per_layer"] if m["name"] == metric]
    assert (entry["source"], entry["unit"], entry["better"]) == ("program_span", "ms", "lower")
    assert entry["workloads"] == [READERS[metric]]
    assert entry["layer"] == ("optimizer" if metric == "train_optimizer_ms" else "model step")
    cell = bench.load_cell(READERS[metric])
    assert metric in {m["name"] for m in cell.per_layer}
    assert entry["moves"] in {m["name"] for m in cell.end_to_end}
    assert callable(bench.reader(metric))


def _mean_span_ms(run, name):
    found = [s for s in run.spans if s[0] == name and run.in_window(s[1])]
    return sum(s[2] - s[1] for s in found) * 1e3 / len(found)


@pytest.mark.parametrize("loop", [serve, train], ids=["serve", "train"])
def test_a_traced_tiny_run_reads_the_device_spans(loop):
    traffic = tiny.SERVE if loop is serve else tiny.TRAIN
    c = tiny.cell(tiny.DENSE, traffic, trace_s=0.5)
    run, numbers, *_ = loop.run(c, 5, 2.0, True, "cpu", time.perf_counter())
    if loop is serve:
        attention, device = bench.reader("decode_attention_ms")(run), bench.reader("decode_device_ms")(run)
        assert 0 < attention <= device <= bench.reader("decode_step_ms")(run)
    else:
        phases = [bench.reader(f"train_{p}_ms")(run) for p in ("forward", "backward", "optimizer")]
        assert all(p > 0 for p in phases)
        assert sum(phases) <= _mean_span_ms(run, "train_step")
