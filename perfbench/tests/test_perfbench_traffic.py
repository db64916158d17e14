"""The traffic generator: the same requests for the same seed, and the same
work in another order for another seed."""

import json

import numpy as np
import pytest

from perfbench.tests import tiny  # noqa: F401
from perfbench.harness import bench, generate

TRAFFIC = bench.HERE / "traffic"
SERVING = sorted(p.stem for p in TRAFFIC.glob("*.json") if json.loads(p.read_text())["loop"] != "train")


def _traffic(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def _take(traffic, seed, n, vocab=1000):
    stream = generate.Requests(traffic, vocab, seed)
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("name", SERVING)
def test_same_seed_same_requests(name):
    t = _traffic(name)
    a, b = _take(t, 2**31 + 7, 3 * t["block"]), _take(t, 2**31 + 7, 3 * t["block"])
    for (pa, oa, ga), (pb, ob, gb) in zip(a, b):
        assert np.array_equal(pa, pb) and oa == ob and ga == gb


@pytest.mark.parametrize("name", SERVING)
def test_other_seed_same_work_per_block(name):
    t = _traffic(name)
    n = t["block"]
    a, b = _take(t, 1, 2 * n), _take(t, 2, 2 * n)
    assert [len(p) for p, _, _ in a] != [len(p) for p, _, _ in b]
    for k in range(2):
        blk_a, blk_b = a[k * n:(k + 1) * n], b[k * n:(k + 1) * n]
        assert sorted(len(p) for p, _, _ in blk_a) == sorted(len(p) for p, _, _ in blk_b)
        assert sorted(o for _, o, _ in blk_a) == sorted(o for _, o, _ in blk_b)
        if t.get("rate_per_s"):
            assert sum(g for _, _, g in blk_a) == pytest.approx(n / t["rate_per_s"])
            assert sorted(g for _, _, g in blk_a) == pytest.approx(sorted(g for _, _, g in blk_b))


@pytest.mark.parametrize("name", SERVING)
def test_sizes_stay_in_their_range(name):
    t = _traffic(name)
    for p, o, _ in _take(t, 5, t["block"]):
        assert t["prompt"]["min"] <= len(p) <= t["prompt"]["max"]
        assert t["output"]["min"] <= o <= t["output"]["max"]
        assert len(p) + o <= t["engine"]["max_len"] + 1


def test_lognormal_median_and_quantiles():
    d = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 64, "max": 1536}
    assert generate.quantile(d, 0.5) == pytest.approx(512)
    assert generate.quantile(d, 0.999) == 1536 and generate.quantile(d, 1e-6) == 64
    u = {"dist": "loguniform", "min": 4096, "max": 16384}
    assert generate.quantile(u, 0.5) == pytest.approx(8192)


def test_train_batches_are_seeded_and_rows_differ():
    a = generate.train_batch(50304, 8, 64, 2**31 + 3, 0)
    b = generate.train_batch(50304, 8, 64, 2**31 + 3, 0)
    c = generate.train_batch(50304, 8, 64, 2**31 + 3, 1)
    assert np.array_equal(a["tokens"], b["tokens"]) and not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert len({r.tobytes() for r in a["tokens"]}) == 8
