"""repro_torch.quant and repro_torch.optim.grad_compress against repro's.

The same numpy inputs go through both packages on the CPU.  Tolerances:
  * quantization (``quantize_rows``, ``quantize_kv``, ``quantize_int8``,
    ``compress_with_feedback``): bit-equal payloads and scales — the same
    IEEE division, half-to-even rounding and clip on both sides;
  * the int32 accumulators of ``int8_dot`` / ``int8_dot_batched``: bit-equal
    (exact integer products on both sides);
  * their outputs: 1e-6 relative to the output's largest |value| (the
    epilogue is the same two fp32 products; XLA may fuse them otherwise);
  * straight-through gradients: 1e-5 of the largest |value| (fp32 matmuls
    summed in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.quant import quantize as jqz  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.quant import quantize as tqz  # noqa: E402

OUT_REL = 1e-6
GRAD_REL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _equal(ours, ref):
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(ref))


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    err = np.abs(ours.detach().float().numpy() - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_and_kv_bit_equal(dtype):
    """Both quantizers, on a row of zeros (the EPS scale), half-way values
    (round half to even) and random rows, in fp32 and bf16."""
    x = _rng().standard_normal((3, 5, 16)).astype(np.float32) * 3.0
    x[0, 0] = 0.0
    x[0, 1] = np.arange(16) - 7.5  # scale 8.5 / 127: several exact halves once scaled
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    for axis in (-1, 1):
        (q, s), (rq, rs) = tq.quantize_rows(tx, axis), jq.quantize_rows(jx, axis)
        _equal(q, rq)
        _equal(s, rs)
    (q, s), (rq, rs) = tq.quantize_kv(tx), jq.quantize_kv(jx)
    _equal(q, rq)
    _equal(s, rs)
    _equal(tq.dequantize_kv(q, s), jq.dequantize_kv(rq, rs))
    assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_per_tensor_quantize_and_compress_with_feedback_bit_equal():
    """``quantize_int8`` round-trips, and three steps of error feedback
    carry the same residual on both sides."""
    rng = _rng(1)
    x = rng.standard_normal((7, 9)).astype(np.float32)
    (q, s), (rq, rs) = tq.quantize_int8(torch.from_numpy(x)), jq.quantize_int8(jnp.asarray(x))
    _equal(q, rq)
    _equal(s, rs)
    _equal(tq.dequantize_int8(q, s), jq.dequantize_int8(rq, rs))

    shapes = {"a": (4, 6), "b": {"c": (3,), "d": (2, 5)}}

    def tree(seed):
        r = _rng(seed)
        return jax.tree.map(lambda sh: r.standard_normal(sh).astype(np.float32) * 1e-2, shapes,
                            is_leaf=lambda v: isinstance(v, tuple))

    jres = jgc.init_residual(jax.tree.map(jnp.asarray, tree(0)))
    tres = tgc.init_residual(params_from_jax(tree(0), "cpu"))
    for step in range(3):
        g = tree(10 + step)
        jout = jgc.compress_with_feedback(jax.tree.map(jnp.asarray, g), jres)
        tout = tgc.compress_with_feedback(params_from_jax(g, "cpu"), tres)
        for ours, ref in zip(tout, jout):
            for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
                _equal(a, b)
        jres, tres = jout[2], tout[2]


def _ref_acc(x, w, per_channel):
    """The reference's int32 accumulator (``_int8_dot_impl`` up to the
    epilogue)."""
    xq, _ = jqz.quantize_rows(x)
    wq, _ = jqz._quantize_weight(w, per_channel, contract_axis=0)
    return jax.lax.dot_general(xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(6, 32), (2, 5, 32)])
def test_int8_dot_matches_reference(shape, per_channel):
    rng = _rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((32, 24)) * np.linspace(0.1, 3.0, 24)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    acc, _, _ = tqz.int8_accumulate(tx, tw, per_channel)
    assert acc.dtype == torch.int32
    _equal(acc, _ref_acc(jnp.asarray(x), jnp.asarray(w), per_channel))
    ref = jq.int8_dot(jnp.asarray(x), jnp.asarray(w), per_channel=per_channel)
    _close(tq.int8_dot(tx, tw, per_channel=per_channel), ref, OUT_REL)


@pytest.mark.parametrize("per_channel", [True, False])
def test_int8_dot_batched_has_per_expert_scales(per_channel):
    """x [E, C, d] @ w [E, d, f]: each expert's own weight scales (the
    reference's vmap), so experts of very different magnitudes keep their
    precision."""
    rng = _rng(3)
    e, c, d, f = 4, 5, 16, 8
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * np.array([1e-3, 1.0, 10.0, 1e2])[:, None, None]).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    acc, _, _ = tqz.int8_accumulate(tx, tw, per_channel, experts=True)
    ref_acc = jax.vmap(lambda a, b: _ref_acc(a, b, per_channel))(jnp.asarray(x), jnp.asarray(w))
    _equal(acc, ref_acc)
    ref = jq.int8_dot_batched(jnp.asarray(x), jnp.asarray(w), per_channel=per_channel)
    out = tq.int8_dot_batched(tx, tw, per_channel=per_channel)
    _close(out, ref, OUT_REL)
    for i in range(e):  # each expert alone gives its slice of the batch
        torch.testing.assert_close(out[i], tq.int8_dot(tx[i], tw[i], per_channel=per_channel),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_int8_dot_straight_through_grads(batched):
    rng = _rng(4)
    xs, ws = ((3, 4, 16), (3, 16, 8)) if batched else ((2, 4, 16), (16, 8))
    x, w = rng.standard_normal(xs).astype(np.float32), rng.standard_normal(ws).astype(np.float32)
    g = rng.standard_normal(xs[:-1] + (8,)).astype(np.float32)
    jfn = jq.int8_dot_batched if batched else jq.int8_dot
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (tq.int8_dot_batched if batched else tq.int8_dot)(tx, tw).backward(torch.from_numpy(g))
    _close(tx.grad, rdx, GRAD_REL)
    _close(tw.grad, rdw, GRAD_REL)


def test_policy_matches_reference():
    """Every --quant flag: the same policy, the same activity by layer
    class, and ``dot`` runs int8 only where the policy covers the class."""
    rng = _rng(5)
    x, w = rng.standard_normal((4, 16)).astype(np.float32), rng.standard_normal((16, 8)).astype(np.float32)
    for flag in tq.QUANT_FLAGS:
        ours, ref = tq.parse_quant(flag), jq.parse_quant(flag)
        assert (ours is None and ref is None) or dataclasses.asdict(ours) == dataclasses.asdict(ref)
        tpol, jpol = tq.Quant(ours), jq.Quant(ref)
        assert (tpol.per_channel, tpol.quantized_kv) == (jpol.per_channel, jpol.quantized_kv)
        for cls in tq.LAYER_CLASSES:
            assert tpol.active(cls) == jpol.active(cls)
            out = tpol.dot(torch.from_numpy(x), torch.from_numpy(w), cls)
            _close(out, jpol.dot(jnp.asarray(x), jnp.asarray(w), cls), OUT_REL)
            if not tpol.active(cls):
                torch.testing.assert_close(out, torch.from_numpy(x @ w), rtol=0, atol=0)


def test_tree_bytes_of_the_int8_cache():
    """The int8 KV cache's footprint equals the reference's, and is
    (d + 4) / (4 d) of the fp32 cache's."""
    cfg, jcfg = get_smoke_config("olmo-1b", "int8"), jax_smoke_config("olmo-1b", "int8")
    qcache, fcache = tm.init_cache(cfg, 2, 16, "cpu"), tm.init_cache(get_smoke_config("olmo-1b"), 2, 16, "cpu")
    assert isinstance(qcache, tm.QuantKVCache)
    assert tq.tree_bytes(qcache) == jq.tree_bytes(jm.init_cache(jcfg, 2, 16))
    d, lengths = cfg.resolved_head_dim, qcache.lengths.numel() * 4
    assert (tq.tree_bytes(qcache) - lengths) * 4 * d == (tq.tree_bytes(fcache) - lengths) * (d + 4)


@pytest.mark.parametrize("m, k, n", [(7, 768, 4), (33, 13, 16), (5, 21, 3)])
def test_int_mm_width_padding_is_exact(m, k, n):
    """The zero padding ``_int_mm`` gives widths that are not multiples of 8
    on the card leaves the int32 product unchanged, bit for bit: xlstm's
    [768, 4] gate projections, an odd contraction, both widths odd."""
    gen = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    pa, pb = tqz.pad_widths(a, b)
    assert pa.shape[1] % tqz.INT_MM_WIDTH_MULTIPLE == 0 and pb.shape[1] % tqz.INT_MM_WIDTH_MULTIPLE == 0
    padded = (pa.to(torch.int32) @ pb.to(torch.int32))[:, :n]
    assert torch.equal(padded, a.to(torch.int32) @ b.to(torch.int32))
