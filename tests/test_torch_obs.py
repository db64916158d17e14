"""repro_torch telemetry (``obs.trace``, ``obs.mfu``, the engine's and the
trainer's metrics, ``launch/scrape_log``) against repro's, on the CPU.

Held here:
  * the Tracer's events (name, ph, cat, pid, tid, args; timestamps
    excluded) equal ``repro.obs.trace``'s for the same calls;
  * the FLOP closed forms and the MFU meter's records equal the
    reference's exactly, for the full olmo-1b, qwen3-moe and arctic configs;
  * after the same schedule (vanilla and speculative), the engine's
    ``serve_*_total`` counters, its histogram counts and its model-FLOPs
    counters equal the JAX engine's, and its trace has the reference's spans;
  * the Trainer's JSONL records have the reference's keys, and
    ``scrape_log`` reads both streams alike (and equals the reference's
    scraper on every log);
  * both launchers' ``--metrics-out`` and ``--trace-out``;
  * ``watch_jit_compiles`` counts the kernel libraries built (a stubbed
    ``nvcc``): one build 1, a rebuilt hash 1 more, a cache hit nothing, each
    forwarded to the counter;
  * device spans: on the CPU each is its host interval on the ``device``
    lane; ``NullTracer.span`` is one shared null context; ``using`` restores
    the ambient tracer; the engine and the trainer carry their own tracer to
    the model's and the optimizer's spans, and no device span takes a name
    that the engine or the trainer gives a host span.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import scrape_log as jax_scrape_log  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.obs import mfu as jax_mfu  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.obs.metrics import Registry as JaxRegistry  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.spec import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import scrape_log  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.obs import NullTracer, Registry, Tracer, get_tracer, mfu, set_tracer, using  # noqa: E402
from repro_torch.obs.trace import DEVICE_TID  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

FULL_ARCHS = ["olmo-1b", "qwen3-moe-235b-a22b", "arctic-480b", "zamba2-1.2b", "xlstm-125m"]


# -- tracing ------------------------------------------------------------------


def _drive_tracer(tr):
    with tr.span("outer", cat="t", tid=1, args={"k": 1}):
        with tr.span("inner", cat="t", tid=1):
            pass
    tr.instant("marker", tid=1, args={"rid": 7})
    tr.complete("retro", 0.001, 0.002, tid=2)
    tr.complete_abs("abs", 10.0, 10.5, cat="request", tid=3, args={"rid": 2})
    tr.thread_name(1, "slot 1")
    with tr.span("default_lane"):
        pass


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_tracer_events_equal_reference(tmp_path):
    ours, ref = Tracer(process_name="p", pid=3), jax_trace.Tracer(process_name="p", pid=3)
    _drive_tracer(ours)
    _drive_tracer(ref)
    assert _untimed(ours.events) == _untimed(ref.events)
    ours.save(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert _untimed(doc["traceEvents"]) == _untimed(ref.to_dict()["traceEvents"])
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["outer"]["ts"] <= spans["inner"]["ts"]
    assert spans["inner"]["ts"] + spans["inner"]["dur"] <= spans["outer"]["ts"] + spans["outer"]["dur"] + 1e-3
    assert spans["abs"]["dur"] == pytest.approx(0.5e6)


def test_span_reaches_torch_profiler():
    tr = Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("traced_block"):
            torch.ones(4).sum()
    assert "traced_block" in {e.key for e in prof.key_averages()}


def test_null_tracer_and_ambient_tracer():
    assert isinstance(get_tracer(), NullTracer)
    null = get_tracer()
    with null.span("x", tid=1, args={"a": 1}):
        pass
    null.complete("x", 0.0, 1.0)
    assert null.to_dict() == {"traceEvents": [], "displayTimeUnit": "ms"}
    tr = Tracer()
    set_tracer(tr)
    try:
        assert get_tracer() is tr
    finally:
        set_tracer(None)
    assert get_tracer() is null


# Host spans of the engine and the trainer, some read by name by the
# benchmark's readers (perfbench/harness/stats.spans matches names only).
HOST_SPANS = {"generate", "prefill", "queued", "decode", "train_step", "draft", "verify"}


def _device_spans(tr):
    return [e for e in tr.events if e.get("ph") == "X" and e["tid"] == DEVICE_TID]


def test_device_span_on_cpu_is_its_host_interval_on_the_device_lane():
    tr = Tracer()
    with tr.span("host", tid=1):
        with tr.span("on_device", args={"live": 3}, device=True):
            torch.ones(64).sum()
    assert [e["name"] for e in tr.events if e.get("ph") == "X"] == ["host"]  # nothing before the flush
    tr.flush()
    (dev,) = _device_spans(tr)
    (host,) = [e for e in tr.events if e.get("name") == "host"]
    assert dev["name"] == "on_device" and dev["cat"] == "device" and dev["args"] == {"live": 3}
    assert host["ts"] <= dev["ts"] and dev["ts"] + dev["dur"] <= host["ts"] + host["dur"] + 1e-3
    assert {"ph": "M", "name": "thread_name", "pid": 0, "tid": DEVICE_TID, "args": {"name": "device"}} in tr.events
    tr.flush()  # nothing pending: nothing more
    assert len(_device_spans(tr)) == 1


def test_device_span_reaches_torch_profiler():
    tr = Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("device_block", device=True):
            torch.ones(4).sum()
    assert "device_block" in {e.key for e in prof.key_averages()}


def test_null_tracer_span_is_one_shared_context_and_records_nothing():
    null = NullTracer()
    first = null.span("a", tid=1, args={"a": 1})
    assert null.span("b", device=True) is first and get_tracer().span("c") is first
    with first as entered:
        with first:
            pass
    assert entered is get_tracer()
    null.flush()
    assert null.events == () and null.to_dict() == {"traceEvents": [], "displayTimeUnit": "ms"}


def test_using_restores_the_ambient_tracer_also_on_an_exception():
    outer, inner = Tracer(), Tracer()
    assert isinstance(get_tracer(), NullTracer)
    with using(outer):
        assert get_tracer() is outer
        with pytest.raises(RuntimeError):
            with using(inner):
                assert get_tracer() is inner
                raise RuntimeError("step failed")
        assert get_tracer() is outer
    assert isinstance(get_tracer(), NullTracer)


def test_moe_and_int8_stages_are_device_spans():
    cfg = get_smoke_config("qwen3-moe-235b-a22b", quant="int8")
    params = init_params(cfg, 0, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, cfg.vocab_size, (1, 8)))
    tr = Tracer()
    with torch.no_grad(), using(tr):
        forward(params, cfg, tokens=tokens)
    tr.flush()
    names = [e["name"] for e in _device_spans(tr)]
    for stage in ("moe_dispatch", "moe_experts", "moe_combine"):
        assert names.count(stage) == cfg.num_layers, stage
    assert names.count("int8_quantize") == names.count("int8_int_mm") > 0
    assert not [e for e in tr.events if e.get("ph") == "X" and e["tid"] != DEVICE_TID]


# -- MFU accounting -----------------------------------------------------------


@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_flop_closed_forms_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    contexts = [0, 17, 1536, 2047]
    assert mfu.train_step_flops(cfg, 4, 2048) == jax_mfu.train_step_flops(jcfg, 4, 2048)
    for n in (1, 64, 1536, 2048):
        assert mfu.prefill_flops(cfg, n) == jax_mfu.prefill_flops(jcfg, n)
    assert mfu.decode_flops(cfg, contexts) == jax_mfu.decode_flops(jcfg, contexts)
    for k in (1, 4, 7):
        assert mfu.verify_flops(cfg, contexts, k) == jax_mfu.verify_flops(jcfg, contexts, k)
    for seq in (64, 2048, 16384):
        assert mfu.paper_ideal_flops_per_s(seq) == jax_mfu.paper_ideal_flops_per_s(seq)
    assert mfu.PAPER_ARRAY.peak_flops_per_s == jax_mfu.PAPER_ARRAY.peak_flops_per_s == pytest.approx(49.152e12)


@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_mfu_meter_records_equal_reference(arch):
    ours, ref = mfu.MFUMeter(get_config(arch), Registry()), jax_mfu.MFUMeter(jax_get_config(arch), JaxRegistry())
    calls = [("train_step", (4, 2048, 0.3)), ("prefill", (1536, 0.02)), ("decode", ([64, 1100, 700], 0.03)),
             ("verify", ([64, 1100], 4, 0.04))]
    for name, args in calls:
        assert getattr(ours, name)(*args) == getattr(ref, name)(*args)
    assert ours.registry.snapshot() == ref.registry.snapshot()


# -- the serving engine ---------------------------------------------------------

SCHEDULE = [(5, 6), (13, 4), (24, 5), (9, 3), (17, 6)]


@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_smoke_config("olmo-1b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, get_smoke_config("olmo-1b"), params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _run_both(olmo, spec, tracer=None):
    jcfg, jparams, tcfg, tparams = olmo
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jcfg.vocab_size, n).astype(np.int32) for n, _ in SCHEDULE]
    kw = dict(batch_size=2, max_len=64, prefill_buckets=(8, 16, 32))
    ours = ServeEngine(tcfg, tparams, spec=spec and SpecConfig(lookahead=spec), tracer=tracer, device="cpu", **kw)
    ref = JaxServeEngine(jcfg, jparams, spec=spec and JaxSpecConfig(lookahead=spec),
                         draft_params=jparams if spec else None, **kw)
    outs = []
    for engine, request in ((ours, Request), (ref, JaxRequest)):
        for i, p in enumerate(prompts):
            engine.submit(request(rid=i, prompt=p, max_new_tokens=SCHEDULE[i][1]))
        outs.append({r.rid: r.output for r in engine.run()})
    assert outs[0] == outs[1]
    return ours, ref


@pytest.mark.parametrize("spec", [None, 4])
def test_engine_metrics_equal_jax(olmo, spec):
    ours, ref = _run_both(olmo, spec)
    ours_snap, ref_snap = ours.registry.snapshot(), ref.registry.snapshot()
    # Counters: every one of the port's equals the reference's (the model
    # FLOPs included: they depend on shapes only).
    assert set(ours_snap["counters"]) <= set(ref_snap["counters"])
    assert {k for k in ours_snap["counters"] if k.startswith("serve_")} == {
        k for k in ref_snap["counters"] if k.startswith("serve_")}
    for name, series in ours_snap["counters"].items():
        assert series == ref_snap["counters"][name], name
    # Histograms: the same families and observation counts (not times).
    assert set(ours_snap["histograms"]) == set(ref_snap["histograms"])
    for name, series in ours_snap["histograms"].items():
        assert {k: v["count"] for k, v in series.items()} == {
            k: v["count"] for k, v in ref_snap["histograms"][name].items()}, name
    batch_util = ours.registry.get("serve_batch_utilization")
    assert batch_util.sum == ref.registry.get("serve_batch_utilization").sum
    # Gauges: the same families and, for those that count, the same values.
    assert set(ours_snap["gauges"]) == set(ref_snap["gauges"])
    for name in ("serve_slot_occupancy", "serve_queue_depth") + (("spec_acceptance_rate",) if spec else ()):
        assert ours_snap["gauges"][name] == ref_snap["gauges"][name], name
    assert ours.stats == {k: int(ours.registry.get(f"serve_{k}_total").value) for k in ours.stats}
    assert ours.registry.get("serve_tokens_total").value == ours.stats["prefill_calls"] + sum(
        n for _, n in SCHEDULE) - len(SCHEDULE)
    for phase in ("prefill", "verify" if spec else "decode"):
        assert ours.registry.get("mfu").labels(phase=phase).value > 0


@pytest.mark.parametrize("spec", [None, 4])
def test_engine_trace_spans(olmo, spec, tmp_path):
    tr = Tracer()
    ours, _ = _run_both(olmo, spec, tracer=tr)
    tr.save(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("prefill") == ours.stats["prefill_calls"]
    assert names.count("queued") == names.count("decode") == names.count("retire") == len(SCHEDULE)
    if spec:
        assert names.count("verify") == ours.stats["verify_steps"]
        assert (spec + 1) * names.count("draft") == ours.stats["draft_steps"]
        assert "generate" not in names
    else:
        assert names.count("generate") == ours.stats["decode_steps"]


def test_engine_stats_is_a_snapshot(olmo):
    ours, _ = _run_both(olmo, None)
    stats = ours.stats
    stats["prefill_calls"] = 999
    assert ours.stats["prefill_calls"] == len(SCHEDULE)


# -- the trainer and scrape_log -------------------------------------------------


def _train(trainer_cls, cfg_cls, shape_cls, cfg, tmp_path, name, **kw):
    jsonl = tmp_path / f"{name}.jsonl"
    tcfg = cfg_cls(total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / f"ck_{name}"), log_every=100,
                   metrics_jsonl=str(jsonl))
    trainer = trainer_cls(cfg, shape_cls("t", 16, 2, "train"), tcfg, **kw)
    state = trainer.run()
    return trainer, state, jsonl.read_text()


def test_trainer_jsonl_and_scrape_log_equal_reference(tmp_path):
    ours, state, text = _train(Trainer, TrainerConfig, ShapeConfig, get_smoke_config("olmo-1b"), tmp_path,
                               "ours", device="cpu")
    ref, _, ref_text = _train(JaxTrainer, JaxTrainerConfig, JaxShapeConfig, jax_smoke_config("olmo-1b"),
                              tmp_path, "ref")
    records, ref_records = scrape_log.scrape(text), scrape_log.scrape(ref_text)
    assert len(records) == len(ref_records) == 3
    for r, q in zip(records, ref_records):
        assert list(r) == list(q)  # the same keys, in order
        assert (r["event"], r["step"]) == (q["event"], q["step"])
        assert r["mfu"] > 0 and r["step_s"] > 0 and np.isfinite(r["loss"])
    assert [r["loss"] for r in records] == pytest.approx(state["losses"])
    # The port's scraper is the reference's, on both streams, a noisy log
    # and a dry-run log (the regex path).
    dryrun = ("== yi-9b x train_4k on 8x4 (32 chips) ==\nlower 1.5s compile 12.0s\n"
              "per-device bytes: 3.25 GiB\n")
    for log in (text, ref_text, "step 1 loss 5.0 gnorm 1.0 3 ms\n" + text + "not json {\n", dryrun):
        assert scrape_log.scrape(log) == jax_scrape_log.scrape(log)
    # The registries hold the reference's families.
    ours_snap, ref_snap = ours.registry.snapshot(), ref.registry.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert set(ours_snap[kind]) == set(ref_snap[kind]), kind
    for name in ("train_steps_total", "train_tokens_total", "watchdog_heartbeats_total"):
        assert ours_snap["counters"][name] == ref_snap["counters"][name]
    assert ours_snap["counters"]["model_flops_total"] == ref_snap["counters"]["model_flops_total"]


def test_trainer_spans(tmp_path):
    tr = Tracer()
    _train(Trainer, TrainerConfig, ShapeConfig, get_smoke_config("olmo-1b"), tmp_path, "traced",
           tracer=tr, device="cpu")
    steps = [e for e in tr.events if e.get("name") == "train_step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]


@pytest.mark.parametrize("spec", [None, 4])
def test_engine_device_spans_reach_the_engines_tracer(olmo, spec):
    _, _, cfg, params = olmo
    tr = Tracer()
    engine = ServeEngine(cfg, params, batch_size=2, max_len=64, prefill_buckets=(8, 16, 32),
                         spec=spec and SpecConfig(lookahead=spec), tracer=tr, device="cpu")
    rng = np.random.default_rng(4)
    for i, (n, new) in enumerate(SCHEDULE):
        engine.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n), max_new_tokens=new))
    engine.run()
    assert isinstance(get_tracer(), NullTracer)  # the ambient tracer was left alone
    names = [e["name"] for e in _device_spans(tr)]
    if spec:
        # decode_step wraps only the vanilla generate's call; the draft's
        # decode steps still run each layer's decode attention.
        assert "decode_step" not in names
        assert names.count("decode_attention") == cfg.num_layers * engine.stats["draft_steps"]
    else:
        assert names.count("decode_step") == engine.stats["decode_steps"] > 0
        assert names.count("decode_attention") == cfg.num_layers * engine.stats["decode_steps"]
        # Each decode step's device span lies in its generate host span.
        generate = [e for e in tr.events if e.get("name") == "generate"]
        steps = [e for e in _device_spans(tr) if e["name"] == "decode_step"]
        for g, d in zip(generate, steps):
            assert g["ts"] <= d["ts"] and d["ts"] + d["dur"] <= g["ts"] + g["dur"] + 1e-3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_device_spans_split_each_step(tmp_path, microbatches):
    tr = Tracer()
    tcfg = TrainerConfig(total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "ck"), log_every=100,
                         num_microbatches=microbatches)
    Trainer(get_smoke_config("olmo-1b"), ShapeConfig("t", 16, 2, "train"), tcfg, tracer=tr, device="cpu").run()
    assert isinstance(get_tracer(), NullTracer)
    steps = [e for e in tr.events if e.get("name") == "train_step"]
    assert len(steps) == 3
    for step in steps:
        inside = [e["name"] for e in _device_spans(tr)
                  if step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"] + 1e-3]
        assert inside == ["forward", "backward"] * microbatches + ["optimizer"]


def test_no_device_span_takes_a_host_spans_name(olmo, tmp_path):
    _, _, cfg, params = olmo
    tr = Tracer()
    for spec in (None, SpecConfig(lookahead=2)):
        engine = ServeEngine(cfg, params, batch_size=2, max_len=64, prefill_buckets=(8, 16, 32), spec=spec,
                             tracer=tr, device="cpu")
        engine.submit(Request(rid=0, prompt=np.arange(1, 10), max_new_tokens=4))
        engine.run()
    tcfg = TrainerConfig(total_steps=1, ckpt_every=100, ckpt_dir=str(tmp_path / "ck"), log_every=100)
    Trainer(cfg, ShapeConfig("t", 16, 2, "train"), tcfg, tracer=tr, device="cpu").run()
    device = {e["name"] for e in _device_spans(tr)}
    host = {e["name"] for e in tr.events if e.get("ph") == "X" and e["tid"] != DEVICE_TID}
    assert device == {"decode_step", "decode_attention", "forward", "backward", "optimizer"}
    assert HOST_SPANS <= host and not device & host


# -- the launchers ----------------------------------------------------------------


def test_train_launcher_metrics_and_trace(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import train as launcher

    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", ["train", "--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "2",
                                     "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                                     "--metrics-out", str(prom), "--trace-out", str(trace)])
    try:
        launcher.main()
    finally:
        set_tracer(None)
    out = capsys.readouterr().out
    assert "done at step 3 on cpu" in out and "against the paper's FSA array" in out
    assert 'mfu{phase="train"}' in prom.read_text()
    assert [r["step"] for r in scrape_log.scrape((tmp_path / "m.prom.jsonl").read_text())] == [1, 2, 3]
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("train_step") == 3


def test_serve_launcher_metrics_and_trace(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import serve as launcher

    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "olmo-1b", "--device", "cpu", "--requests", "4",
                                     "--max-new", "4", "--spec-draft", "self", "--metrics-out", str(prom),
                                     "--trace-out", str(trace)])
    try:
        launcher.main()
    finally:
        set_tracer(None)
    assert "spec: acceptance 1.000" in capsys.readouterr().out
    text = prom.read_text()
    for needle in ("serve_ttft_seconds_bucket", "serve_tpot_seconds_bucket", "serve_verify_steps_total",
                   "spec_acceptance_rate", 'mfu{phase="verify"}'):
        assert needle in text, needle
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("queued") == 4 and "verify" in names


# -- the build watcher ----------------------------------------------------------


def test_watch_jit_compiles_counts_kernel_builds(monkeypatch, tmp_path):
    """A stubbed ``nvcc`` on PATH and a temporary build directory: the first
    build counts 1, a cache hit 0, a changed source hash (other flags) 1
    more; the counter gets every one; the watcher uninstalls cleanly."""
    import logging
    import os
    import stat

    from repro_torch.kernels import _build
    from repro_torch.obs import watch_jit_compiles
    from repro_torch.obs.metrics import BUILD_LOGGER

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    ': > "$out"\necho "ptxas info    : stub"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    reg = Registry()
    counter = reg.counter("jit_compiles_total", "kernel library builds observed")
    with watch_jit_compiles(counter) as watcher:
        first = _build.build("pwl_exp2")
        assert first.exists() and watcher.count == 1
        assert _build.build("pwl_exp2") == first and watcher.count == 1  # cache hit: silent
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
        second = _build.build("pwl_exp2")
        assert second != first and second.exists() and watcher.count == 2
    assert counter.value == 2
    assert watcher not in logging.getLogger(BUILD_LOGGER).handlers
    _build.build("flash_fwd")  # not watched
    assert watcher.count == 2 and counter.value == 2
