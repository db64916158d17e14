"""The frozen yardstick equals hand-worked values at small shapes, and the
program's own MFU formulas at the benchmark's configurations."""

import pytest

from perfbench.tests import tiny  # noqa: F401
from perfbench.harness import bench, costs

SMALL = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
         "vocab_size": 10, "tie_embeddings": True}


def test_param_counts_by_hand():
    # embed 10*8 + 2 layers * (q 8*8 + k,v 2*8*4 + o 8*8 + mlp 3*8*16)
    assert costs.param_count(SMALL) == 80 + 2 * (64 + 64 + 64 + 384)
    moe = {**SMALL, "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 6}}
    per = 64 + 64 + 64 + 4 * 3 * 8 * 6 + 8 * 4
    assert costs.param_count(moe) == 80 + 2 * per
    assert costs.active_param_count(moe) == 80 + 2 * (per - 2 * 3 * 8 * 6)


def test_model_flops_by_hand():
    n = costs.param_count(SMALL)
    # prefill of 3 tokens: 2*N*3 + attention 4 * ((3+1)/2 keys) * d 4 * heads 2 * layers 2 * 3 tokens
    assert costs.prefill_flops(SMALL, 3) == 2 * n * 3 + 4 * 2.0 * 4 * 2 * 2 * 3
    assert costs.decode_token_flops(SMALL, 5) == 2 * n + 4 * 6 * 4 * 2 * 2
    assert costs.train_step_flops(SMALL, 2, 4) == 6 * n * 8 + 3 * (4 * 2.0 * 4 * 2 * 2) * 8
    assert costs.mfu(989e12, 2.0) == pytest.approx(50.0)


def test_attention_costs_by_hand():
    # causal pairs of 4 rows: 10; 4 * d 8 * 10 * heads 2 * batch 1
    assert costs.attention_fwd_cost(1, 4, 2, 8, 2, 1) == (640, 2 * 1 * 4 * 3 * 8 * 2)
    flops, nbytes = costs.attention_bwd_cost(1, 4, 2, 1, 8, 2)
    assert flops == 2 * 5 * 8 * 10 * 2
    assert nbytes == (4 * 4 * 2 + 4 * 4 * 1) * 8 * 2 + 2 * 2 * 4 * 4


def test_roofline_bound_takes_the_larger_term():
    assert costs.bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert costs.bound_seconds(1.0, 3.35e12) == pytest.approx(1.0)
    assert costs.bound_seconds(989e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("config", [c["name"] for c in bench.benchmark()["configs"]])
def test_frozen_flops_equal_the_programs(config):
    from repro_torch.obs import mfu

    conf = next(c for c in bench.benchmark()["configs"] if c["name"] == config)
    import json

    with open(bench.ROOT / conf["file"]) as f:
        m = json.load(f)["port"]
    cfg = bench.model_config(m)
    assert costs.param_count(m) == cfg.param_count()
    assert costs.active_param_count(m) == cfg.active_param_count()
    assert costs.train_step_flops(m, 8, 2048) == pytest.approx(mfu.train_step_flops(cfg, 8, 2048))
    assert costs.prefill_flops(m, 777) == pytest.approx(mfu.prefill_flops(cfg, 777))
    assert costs.decode_token_flops(m, 300) + costs.decode_token_flops(m, 9) == pytest.approx(
        mfu.decode_flops(cfg, [300, 9]))
