"""repro_torch.tune against repro.tune on the CPU (same seeds and points).

Tolerances: the closed-form metrics of the sweep (``_eval_features``, fp32,
and the speedups derived from its mean utilization) within a relative 1e-6 —
the mean over the 8 sequence lengths may round differently in torch and in
XLA; everything else exactly: counts, labels, frontier indices, the paper
checks, the Fig. 12 and Table 2 statistics, the simulator checks, and the
markdown apart from the last printed digit of a number.
"""

import json
import os
import re
import sys

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.tune as ref_tune  # noqa: E402
import repro.tune.search as ref_search  # noqa: E402
import repro_torch.tune as tune  # noqa: E402
from repro_torch.launch import tune as launcher  # noqa: E402
from repro_torch.tune import search  # noqa: E402

RTOL = 1e-6
_FLOAT_KEYS = set(search._METRICS) | {"speedup_vs_tpu_v5e", "speedup_vs_neuron_v2"}


def _assert_records_equal(ours: list[dict], ref: list[dict]) -> None:
    assert [r["label"] for r in ours] == [r["label"] for r in ref]
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for key in b:
            if key in _FLOAT_KEYS:
                assert a[key] == pytest.approx(b[key], rel=RTOL), (b["label"], key)
            else:
                assert a[key] == b[key], (b["label"], key)


def _assert_reports_equal(ours: dict, ref: dict) -> None:
    assert set(ours) == set(ref)
    for key in ref:
        if key in ("records", "frontier"):
            _assert_records_equal(ours[key], ref[key])
        else:
            assert json.dumps(ours[key], sort_keys=True) == json.dumps(ref[key], sort_keys=True), key


_NUMBER = re.compile(r"-?\d+(?:\.(\d+))?(?:e([+-]\d+))?")


def _assert_markdown_equal(ours: str, ref: str) -> None:
    """Equal text; numbers may differ by one in their last printed digit."""
    assert _NUMBER.sub("#", ours) == _NUMBER.sub("#", ref)
    for a, b in zip(_NUMBER.finditer(ours), _NUMBER.finditer(ref)):
        digits = len(b.group(1) or "")
        unit = 10.0 ** (int(b.group(2) or 0) - digits)
        assert abs(float(a.group(0)) - float(b.group(0))) <= unit * 1.0001, (a.group(0), b.group(0))


@pytest.fixture(scope="module")
def reports():
    """The smoke preset in both packages, the port on 8 CPU devices as the
    reference's mesh has them, and once more for determinism."""
    kw = dict(seed=0, paper_check_seq=512)
    ref = ref_tune.run_tune("smoke", **kw)
    ours = tune.run_tune("smoke", mesh=tune.tune_mesh(8, device="cpu"), device="cpu", **kw)
    again = tune.run_tune("smoke", mesh=tune.tune_mesh(8, device="cpu"), device="cpu", **kw)
    return ours, ref, again


def test_evaluate_paper_point_equal():
    ours = tune.evaluate(tune.paper_point(), accuracy_seq=2048, device="cpu")
    ref = ref_tune.evaluate(ref_tune.paper_point(), accuracy_seq=2048)
    assert ours == ref
    assert f"{ours['pwl_mre']:.3e}" == "2.728e-02"


def test_eval_features_equal():
    """Every point of the full preset: the torch closed forms against the
    reference's jnp ones (rel 1e-6) and the scalar host evaluators (rel
    1e-5, the reference's own tolerance for fp32 against float64)."""
    spec = {k: v for k, v in tune.PRESETS["full"].items() if k != "accuracy_seq"}
    points = tune.grid_space(**spec)
    assert len(points) == 320
    feats = search.encode_points(points)
    ours = search._eval_features(torch.from_numpy(feats)).numpy()
    ref = np.asarray(ref_search._eval_features(jnp.asarray(feats)))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=0)
    for point, row in zip(points[::37], ours[::37]):
        host = {**tune.eval_performance(point), **tune.eval_area(point)}
        for key, value in zip(search._METRICS, row):
            if key in host:
                assert value == pytest.approx(host[key], rel=1e-5), (point.label(), key)


@pytest.mark.parametrize("space", ["even", "ragged"])
def test_grid_sweep_per_device_counts(space):
    points = tune.grid_space(array_ns=(64, 128), segments=(4, 8), sram_overs=(1, 2),
                             freqs=(1.0, 1.5))
    if space == "ragged":
        points = tune.grid_space(array_ns=(64, 128), segments=(4, 8, 16))[:11]
    ours = tune.grid_sweep(points, mesh=tune.tune_mesh(8, device="cpu"), accuracy_seq=256,
                           device="cpu")
    ref = ref_tune.grid_sweep(points, mesh=ref_tune.tune_mesh(), accuracy_seq=256)
    assert ours.per_device_counts == ref.per_device_counts
    assert sum(ours.per_device_counts) == len(points)
    _assert_records_equal(ours.records, ref.records)


def test_tune_mesh_devices():
    assert tune.tune_mesh(device="cpu") == [torch.device("cpu")]
    assert len(tune.tune_mesh(3, device="cpu")) == 3
    with pytest.raises(ValueError):
        tune.tune_mesh(device="meta")


def test_run_tune_smoke_equals_reference(reports):
    ours, ref, _ = reports
    assert ours["paper_checks_ok"] and ours["sim_checks_ok"]
    assert ours["per_device_counts"] == ref["per_device_counts"] == [1] * 8
    _assert_reports_equal(ours, ref)
    _assert_markdown_equal(tune.render_markdown(ours), ref_tune.render_markdown(ref))


def test_run_tune_is_deterministic(reports, tmp_path):
    ours, _, again = reports
    strip = lambda r: {k: v for k, v in r.items() if k != "records"}  # noqa: E731
    assert json.dumps(strip(ours), sort_keys=True) == json.dumps(strip(again), sort_keys=True)
    paths = []
    for i, rep in enumerate((ours, again)):
        md, js = tmp_path / f"r{i}.md", tmp_path / f"r{i}.json"
        tune.write_report(rep, md_path=str(md), json_path=str(js))
        paths.append((md.read_bytes(), js.read_bytes()))
    assert paths[0] == paths[1]


def test_random_search_equal():
    ours = tune.random_search(12, seed=3, accuracy_seq=256, device="cpu")
    ref = ref_tune.random_search(12, seed=3, accuracy_seq=256)
    _assert_records_equal(ours.records, ref.records)


def test_successive_halving_equal():
    points = tune.grid_space(array_ns=(64, 128), segments=(4, 8), sram_overs=(1, 2))
    kw = dict(seed=0, eta=2, fidelities=(128, 256, 512), mesh=None)
    ours = tune.successive_halving(points, device="cpu", **kw)
    ref = ref_tune.successive_halving(points, **kw)
    assert len(ours.records) == len(points) // 4
    _assert_records_equal(ours.records, ref.records)


def test_launcher_writes_its_report(tmp_path, monkeypatch, capsys):
    md, js = tmp_path / "sub" / "report.md", tmp_path / "sub" / "tune.json"
    monkeypatch.setattr(sys, "argv", [
        "tune", "--preset", "paper", "--device", "cpu", "--no-mesh",
        "--paper-check-seq", "512", "--out", str(md), "--json", str(js),
    ])
    launcher.main()
    payload = json.loads(js.read_text())
    ref = ref_tune.run_tune("paper", seed=0, mesh=False, paper_check_seq=512)
    assert payload["paper_checks_ok"] and payload["sim_checks_ok"]
    assert payload["paper"] == ref["paper"]
    assert "Pareto frontier" in md.read_text()
    assert "wrote" in capsys.readouterr().out
