"""int8 quantized matmul primitives (counterpart of ``repro.quant.quantize``).

The forward path is integer-domain end to end: dynamic per-row symmetric
int8 quantization of the activation, symmetric quantization of the weight
(per output channel or per tensor), an int8 x int8 -> **int32** product and
a dequant epilogue ``acc * x_scale * w_scale``, evaluated left to right in
fp32 as the reference does.

The int32 product is exact on both devices and never a float product
(fp32 sums of int8 products stop being exact past 2**24, and 127**2 * 4096
is about 6.6e7):

  * on the CPU, an int32 ``@`` of the int8 payloads;
  * on CUDA, ``torch._int_mm`` (cuBLASLt's int8 GEMM; the reference's
    counterpart is ``lax.dot_general`` outside any Pallas kernel).  It takes
    more than 16 rows and widths in multiples of 8: the rows are padded with
    zero rows to a multiple of 32 and cut away after; a width it cannot take
    raises.

Gradients are straight-through (AQT-style): the backward is the plain fp32
matmul against the unquantized operands, cast back to x's and w's dtypes.

``int8_dot_batched`` is the reference's ``vmap(int8_dot)``: each expert of
the stack gets its own weight scales (per tensor: one scalar an expert; per
channel: one an output channel of that expert) and its own product.

Under a mesh the model's islands (``models.parallel``) hand a product the
rank's shards; a ``Split`` says how they lie in the whole operands, and the
product takes the whole operands' scales and int32 sum by collectives, so
that every rank gets the unsharded answer bit for bit, as the reference's
GSPMD does.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

INT8_MAX = 127.0
_EPS = 1e-20
# torch._int_mm on CUDA: rows > 16, contraction and output widths % 8 == 0.
# On the H100 cuBLASLt also refused 17 rows at contraction width 64
# (CUBLAS_STATUS_NOT_SUPPORTED), so rows are padded to a multiple of 32
# (tests/test_torch_cuda.py runs every row count 1-40 at widths 16-96), and
# both widths are padded with zeros to a multiple of 8 (xlstm's [768, 4]
# gate projections).
INT_MM_ROW_MULTIPLE = 32
INT_MM_WIDTH_MULTIPLE = 8

# _int_mm calls made by int8 products on CUDA since the last reset (read by
# chip_smoke.py).
int_mm_calls = 0


def reset_counts() -> None:
    global int_mm_calls
    int_mm_calls = 0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, EPS) / 127 as a true division.  The divisor is a tensor on
    amax's device: PyTorch's CUDA division by a host scalar multiplies by
    its reciprocal, which can land one ulp off the quotient."""
    return torch.clamp(amax, min=_EPS) / torch.full((), INT8_MAX, dtype=amax.dtype, device=amax.device)


def _round_clip(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round, like jnp.round, rounds half to even.
    return torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q int8, scalar scale in
    x's dtype, as the reference's)."""
    scale = _scale(x.abs().max())
    return _round_clip(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_rows(x: torch.Tensor, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: one scale per slice along ``axis``.

    Returns (q int8, scale fp32 with ``axis`` kept at size 1 for broadcast).
    """
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=axis, keepdim=True))
    return _round_clip(xf, scale), scale


def _quantize_weight(w: torch.Tensor, per_channel: bool, experts: bool = False):
    """Weight scales of ``w [d, f]`` (or, with ``experts``, of each
    ``w[e]`` of a stack ``[E, d, f]``): per output channel (reduce the
    contraction axis) or one scalar per tensor."""
    wf = w.float()
    if per_channel:
        amax = wf.abs().amax(dim=-2, keepdim=True)  # [(E,) 1, f]
    elif experts:
        amax = wf.abs().amax(dim=(-2, -1), keepdim=True)  # [E, 1, 1]
    else:
        amax = wf.abs().max()
    scale = _scale(amax)
    return _round_clip(wf, scale), scale


class Split(NamedTuple):
    """How the operands of an int8 product are parts of the whole ones.

    * ``"contraction"`` (row-parallel): x's last dim and w's rows are split
      over ``group``.  x's row absmax and w's absmax are MAX all-reduced
      over it, and the int32 accumulator is SUM all-reduced (exact: 127**2
      times the widest contraction of ``configs/``, qwen2.5-32b's d_ff of
      27648, is 4.5e8 < 2**31), so the epilogue sees the whole sum.
    * ``"columns"`` (column-parallel): w's columns are split over
      ``group``, or w is a column slice of ``whole``, a weight every rank
      holds.  Per channel the scales are already whole; per tensor, the
      one absmax is MAX all-reduced over ``group`` or taken of ``whole``.
    """

    kind: str
    group: Any = None
    whole: Optional[torch.Tensor] = None


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def _quantize_split(x: torch.Tensor, w: torch.Tensor, per_channel: bool, split: Split):
    """``quantize_rows(x)`` and ``_quantize_weight(w, per_channel)`` with
    the whole operands' absmax (see ``Split``)."""
    xf, wf = x.float(), w.float()
    xa = xf.abs().amax(dim=-1, keepdim=True)
    wa = wf.abs().amax(dim=-2, keepdim=True) if per_channel else wf.abs().max()
    if split.kind == "contraction":
        xa, wa = _all_reduce(xa, "max", split.group), _all_reduce(wa, "max", split.group)
    elif not per_channel:
        wa = _all_reduce(wa, "max", split.group) if split.whole is None else split.whole.float().abs().max()
    xs, ws = _scale(xa), _scale(wa)
    return _round_clip(xf, xs), xs, _round_clip(wf, ws), ws


def pad_widths(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a [m, k]`` and ``b [k, n]`` with k and n padded with zeros to
    multiples of ``INT_MM_WIDTH_MULTIPLE``: the zero columns of ``a`` meet
    zero rows of ``b``, so ``(a' @ b')[:, :n]`` equals ``a @ b`` exactly in
    int32."""
    (m, k), n = a.shape, b.shape[1]
    kp = -(-k // INT_MM_WIDTH_MULTIPLE) * INT_MM_WIDTH_MULTIPLE
    np_ = -(-n // INT_MM_WIDTH_MULTIPLE) * INT_MM_WIDTH_MULTIPLE
    if kp != k:
        a = torch.cat([a, a.new_zeros((m, kp - k))], dim=1)
        b = torch.cat([b, b.new_zeros((kp - k, n))])
    if np_ != n:
        b = torch.cat([b, b.new_zeros((kp, np_ - n))], dim=1)
    return a, b


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``a [m, k]`` and ``b [k, n]``."""
    global int_mm_calls
    if not a.is_cuda:
        return a.to(torch.int32) @ b.to(torch.int32)
    m, n = a.shape[0], b.shape[1]
    a, b = pad_widths(a, b)
    rows = max(1, -(-m // INT_MM_ROW_MULTIPLE)) * INT_MM_ROW_MULTIPLE
    if rows != m:
        a = torch.cat([a, a.new_zeros((rows - m, a.shape[1]))])
    int_mm_calls += 1
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def int8_accumulate(
    x: torch.Tensor, w: torch.Tensor, per_channel: bool, experts: bool = False,
    split: Optional[Split] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The integer part of ``x [..., d] @ w [d, f]`` (with ``experts``, of
    ``x [E, ..., d] @ w [E, d, f]``, one product an expert): the int32
    accumulator [..., f], x's row scales [..., 1] and w's scales, shaped to
    broadcast against the accumulator's last axis.  With a ``split``, of
    the whole operands that ``x`` and ``w`` are parts of."""
    # Imported here: repro_torch.obs imports the configs, which import this module.
    from repro_torch.obs import get_tracer

    tracer = get_tracer()
    with tracer.span("int8_quantize", device=True):
        if split is None:
            xq, xs = quantize_rows(x)
            wq, ws = _quantize_weight(w, per_channel, experts)
        else:
            xq, xs, wq, ws = _quantize_split(x, w, per_channel, split)
    d, f = w.shape[-2:]
    with tracer.span("int8_int_mm", device=True):
        if not experts:
            acc = _int_mm(xq.reshape(-1, d), wq)
            if split is not None and split.kind == "contraction":
                acc = _all_reduce(acc, "sum", split.group)
        elif x.is_cuda:  # _int_mm is 2-D: one call an expert
            acc = torch.stack([_int_mm(r, we) for r, we in zip(xq.reshape(w.shape[0], -1, d), wq)])
        else:
            acc = torch.matmul(xq.reshape(w.shape[0], -1, d).to(torch.int32), wq.to(torch.int32))
    # The reference's vmap reshapes each expert's scales to [-1].
    ws = ws.reshape(w.shape[0], *([1] * (x.dim() - 2)), -1) if experts else ws.reshape(-1)
    return acc.reshape(*x.shape[:-1], f), xs, ws


class _Int8Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, per_channel, experts, split):
        ctx.save_for_backward(x, w)
        acc, xs, ws = int8_accumulate(x, w, per_channel, experts, split)
        return (acc.float() * xs * ws).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # Straight-through: gradients of the fp32 matmul w.r.t. the
        # unquantized operands (AQT's default training rule).  Under a
        # split they are the rank's part: dx of a row-parallel product is
        # x's shard, of a column-parallel one a partial sum.
        x, w = ctx.saved_tensors
        g32, w32 = g.float(), w.float()
        lead = (w.shape[0],) if w.dim() == 3 else ()
        dx = torch.matmul(g32.reshape(*lead, -1, g.shape[-1]), w32.transpose(-1, -2))
        x2 = x.float().reshape(*lead, -1, x.shape[-1])
        dw = torch.matmul(x2.transpose(-1, -2), g32.reshape(*lead, -1, g.shape[-1]))
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None, None, None


def int8_dot(
    x: torch.Tensor, w: torch.Tensor, *, per_channel: bool = True, split: Optional[Split] = None
) -> torch.Tensor:
    """Quantized ``x [..., d] @ w [d, f]`` (differentiable, straight-through
    backward); with a ``split``, the rank's shards of larger operands."""
    return _Int8Dot.apply(x, w, per_channel, False, split)


def int8_dot_batched(
    x: torch.Tensor, w: torch.Tensor, *, per_channel: bool = True
) -> torch.Tensor:
    """Expert-batched quantized matmul: x [E, ..., d] @ w [E, d, f], each
    expert as ``int8_dot`` (the reference's vmap)."""
    return _Int8Dot.apply(x, w, per_channel, True, None)


def tree_bytes(tree: Any) -> int:
    """Total bytes of every tensor leaf (cache-footprint accounting); walks
    dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
