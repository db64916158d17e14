"""repro_torch.models.moe against repro.models.moe (its single-shard
branch), and the port's counterparts of tests/test_moe.py's properties.

Same numpy inputs and bridged fp32 weights on the CPU.  Outputs are held at
1e-5 of the largest |reference| value: both sides compute in fp32, and the
matmuls sum in other orders (the gap seen is ~2e-7).  Every capacity-bound
case asserts that copies were dropped, so the stable sort that decides
which copies are kept is exercised.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

REL = 1e-5


def _close(ours, ref, rel=REL):
    ref = np.asarray(ref)
    err = np.abs(ours.detach().numpy() - ref).max()
    assert err <= rel * np.abs(ref).max(), err


def _bridged_moe(jcfg, seed=0):
    jp = jmoe.moe_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_forward_matches_reference(arch, dropless):
    """The smoke configs' MoE (8 experts, top 2), and arctic's dense
    residual beside it, over 96 tokens: capacity 30 binds for some experts
    and the kept copies must be the reference's."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp, tp = _bridged_moe(jcfg)
    x = _x((3, 32, jcfg.d_model))
    tmoe.reset_counts()
    ref = jmoe.moe_forward(jnp.asarray(x), jp, jcfg, dropless=dropless)
    out = tmoe.moe_forward(torch.from_numpy(x), tp, tcfg, dropless=dropless)
    _close(out, ref)
    mode = "dropless" if dropless else "capacity"
    assert tmoe.counts[mode] == 1 and tmoe.counts["copies_" + mode] == 96 * tcfg.moe.top_k
    assert (tmoe.dropped_copies() == 0) == dropless  # capacity binds: fewer than t·k kept
    if jcfg.moe.dense_residual:
        rng = jax.random.PRNGKey(1)
        from repro.models.layers import mlp_params
        jdense = mlp_params(rng, jcfg.d_model, jcfg.d_ff, jcfg.mlp_type, jnp.float32)
        tdense = params_from_jax(jax.tree.map(np.asarray, jdense), "cpu")
        ref = jmoe.moe_with_dense_residual(jnp.asarray(x), jp, jdense, jcfg)
        _close(tmoe.moe_with_dense_residual(torch.from_numpy(x), tp, tdense, tcfg), ref)


def _cfg(e=8, k=2, d=16, ff=32, cf=1.25, cls=ModelConfig, moe_cls=MoEConfig):
    return cls(
        name="m", family="moe", num_layers=1, d_model=d, num_heads=2,
        num_kv_heads=2, d_ff=ff, vocab_size=64, dtype="float32", remat=False,
        moe=moe_cls(num_experts=e, top_k=k, d_ff_expert=ff, capacity_factor=cf),
    )


def _pair(cf=1.25, seed=0):
    jcfg = _cfg(cf=cf, cls=JaxModelConfig, moe_cls=JaxMoEConfig)
    jp, tp = _bridged_moe(jcfg, seed)
    return jcfg, _cfg(cf=cf), jp, tp


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("b,s,seed", [(1, 2, 0), (2, 9, 1), (4, 16, 2)])
def test_expert_partition_sums_to_full(b, s, seed, cf):
    """Two expert slices' parts sum to the whole (the combine a mesh's psum
    would do), and the whole equals the reference's block."""
    jcfg, tcfg, jp, tp = _pair(cf, seed)
    x = _x((b, s, 16), seed)
    tx = torch.from_numpy(x)
    block = lambda lo, hi, off: tmoe._moe_block(  # noqa: E731
        tx, tp["router"], tp["gate"][lo:hi], tp["up"][lo:hi], tp["down"][lo:hi], tcfg, off)
    full, half = block(0, 8, 0), 4
    torch.testing.assert_close(block(0, half, 0) + block(half, 8, half), full, rtol=0, atol=1e-6)
    ref = jmoe._moe_block(jnp.asarray(x), jp["router"], jp["gate"], jp["up"], jp["down"], jcfg, 0)
    _close(full, ref)


def test_no_drop_at_high_capacity_matches_dense_topk():
    """With capacity_factor = E / k (capacity = T) nothing drops, and the
    output is the explicit dense top-k mix, token by token; dropless
    routing gives the same."""
    _, tcfg, _, p = _pair(cf=8 / 2)
    x = torch.from_numpy(_x((2, 8, 16), 1))
    tmoe.reset_counts()
    out = tmoe.moe_forward(x, p, tcfg)
    assert tmoe.dropped_copies() == 0
    torch.testing.assert_close(tmoe.moe_forward(x, p, tcfg, dropless=True), out, rtol=0, atol=0)
    xf = x.reshape(-1, 16)
    top_p, top_e = torch.topk(torch.softmax(xf @ p["router"], -1), 2)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(2):
            e = int(top_e[t, j])
            h = torch.nn.functional.silu(xf[t] @ p["gate"][e]) * (xf[t] @ p["up"][e])
            y[t] += top_p[t, j] * (h @ p["down"][e])
    torch.testing.assert_close(out.reshape(-1, 16), y, rtol=0, atol=1e-5)


def test_capacity_drops_are_bounded():
    """A tight capacity drops most copies: its output stays finite, its
    norm below the no-drop output's, and it still equals the reference's."""
    x = _x((1, 32, 16), 2)
    jtight, tight_cfg, jp, p = _pair(cf=0.1)
    tmoe.reset_counts()
    tight = tmoe.moe_forward(torch.from_numpy(x), p, tight_cfg)
    assert tmoe.dropped_copies() > 32  # capacity 1: at most 8 of 64 copies kept
    loose = tmoe.moe_forward(torch.from_numpy(x), p, _cfg(cf=100.0))
    assert torch.isfinite(tight).all()
    assert float(tight.norm()) < float(loose.norm())
    _close(tight, jmoe.moe_forward(jnp.asarray(x), jp, jtight))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_token_order_equivariance(seed):
    """Permuting tokens permutes outputs (no-drop capacity: only capacity
    ties make routing order-dependent)."""
    _, tcfg, _, p = _pair(cf=100.0)
    x = torch.from_numpy(_x((1, 8, 16), seed))
    perm = torch.from_numpy(np.random.default_rng(seed + 1).permutation(8))
    out = tmoe.moe_forward(x, p, tcfg)[0]
    torch.testing.assert_close(out[perm], tmoe.moe_forward(x[:, perm], p, tcfg)[0], rtol=0, atol=1e-5)


def test_two_calls_are_bit_equal_in_bf16():
    """The combine sums each token's rows in one fixed order: repeated
    calls on the same bf16 input give the same bits."""
    _, tcfg, _, p = _pair()
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    p = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.from_numpy(_x((2, 16, 16), 3)).to(torch.bfloat16)
    first = tmoe.moe_forward(x, p, cfg)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, tmoe.moe_forward(x, p, cfg))


def test_router_margin_tracking():
    """With ``track_margins`` the smallest k-th minus (k+1)-th router
    probability over the calls is kept; off, nothing is tracked."""
    _, tcfg, _, p = _pair()
    x = torch.from_numpy(_x((2, 8, 16), 4))
    probs = torch.softmax(x.reshape(-1, 16) @ p["router"], dim=-1)
    top = torch.topk(probs, 3, dim=-1).values
    want = float((top[:, 1] - top[:, 2]).min())
    tmoe.reset_counts()
    tmoe.moe_forward(x, p, tcfg)
    assert tmoe.min_router_margin() == float("inf")
    tmoe.track_margins = True
    try:
        tmoe.moe_forward(x, p, tcfg)
        tmoe.moe_forward(x[:, :4], p, tcfg)  # a subset: the minimum stays
    finally:
        tmoe.track_margins = False
    assert tmoe.min_router_margin() == want
