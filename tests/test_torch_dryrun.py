"""repro_torch's dry-run (``launch/{cells,dryrun,roofline,report}.py``)
against the reference's.

* The cell list and the skip reasons equal ``repro.configs.registry``'s
  (31 runnable + 9 skipped = 40), and ``input_specs`` gives the reference's
  shapes and dtypes, leaf by leaf, for every runnable cell.
* A miniature dry-run: the smoke olmo-1b and zamba2-1.2b on a 2 x 4 mesh
  of a fake process group, train and decode at batch 4 x 32 tokens.  The
  trace's FLOPs equal the closed-form count of the cell's products within
  1%, each product counted once at its local shard shape and scaled by the
  8 devices (DTensor's global-shape ops are never counted).  A training
  product counts three times (forward, input and weight gradients), the
  plain flash attention's two forward products seven times (FA-2's
  backward recomputes S and runs five).
* ``report.py``'s tables are byte-equal to the reference's for the same
  records (read at the reference's 16 GiB).

``python tests/test_torch_dryrun.py`` prints the miniature cells' FLOPs
beside the reference's XLA count for the same cells (recorded in PERF.md,
not gated).
"""

import contextlib
import dataclasses
import os
import sys

if __name__ == "__main__":  # before JAX starts: the reference's 2 x 4 mesh
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import runnable_cells as jax_runnable_cells  # noqa: E402
from repro.configs.registry import skipped_cells as jax_skipped_cells  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config, runnable_cells, skipped_cells  # noqa: E402
from repro_torch.dist.sharding import tree_map_with_path  # noqa: E402
from repro_torch.launch import cells, report  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402

REL = 0.01  # the trace's FLOPs against the closed form


@contextlib.contextmanager
def fake_mesh(shape, names=("data", "model")):
    """A torch DeviceMesh of ``shape`` over a fake process group (no data
    moves), destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_process_group(int(np.prod(shape))):
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _jpath(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return "/".join(parts)


def test_cells_and_skip_reasons_equal_reference():
    assert runnable_cells() == jax_runnable_cells()
    assert skipped_cells() == jax_skipped_cells()
    assert len(runnable_cells()) == 31 and len(skipped_cells()) == 9


def test_input_specs_equal_reference_for_every_cell():
    for arch, shape_name in runnable_cells():
        ref = jcells.input_specs(jax_get_config(arch), JAX_SHAPES[shape_name])
        ours = cells.input_specs(get_config(arch), SHAPES[shape_name])
        flat, _ = jax.tree_util.tree_flatten_with_path(ref)
        want = {_jpath(p): (tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in flat}
        got = {}
        tree_map_with_path(
            lambda p, x: got.__setitem__(p, (tuple(x.shape), str(x.dtype).replace("torch.", ""))), ours)
        assert got == want, (arch, shape_name)
        assert all(x.device.type == "meta" for x in _leaves(ours))


def _leaves(tree):
    out = []
    tree_map_with_path(lambda _p, x: out.append(x), tree)
    return out


# -- the miniature dry-run and its closed form -----------------------------------------


def _einsum_flops(eq, *shapes) -> int:
    """FLOPs of one einsum's products at these shapes, as torch runs it."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        torch.einsum(eq, *[torch.empty(s, device="meta") for s in shapes])
    return fc.get_total_flops()


def _closed_form(cfg, kind: str, batch: int, seq: int, data: int, model: int) -> int:
    """The cell's products on one rank's shards, times the devices.

    Heads, d_ff and vocab split over "model"; the batch over "data"; the
    Mamba2 block is computed whole on every rank.  Train: each product of
    the forward three times; the plain flash attention's QK^T and PV seven
    times (two in the forward, five in FA-2's backward)."""
    b = batch // data
    t = b * (seq if kind == "train" else 1)
    kv_len = seq  # the decode cache's length (train: the sequence)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads // model, cfg.num_kv_heads // model
    ff, v = cfg.d_ff // model, cfg.vocab_size // model

    def mm(m, k, n):
        return 2 * m * k * n

    def block():  # one transformer block: (products, attention products)
        lin = mm(t, d, hq * hd) + 2 * mm(t, d, hkv * hd) + mm(t, hq * hd, d)
        lin += 2 * mm(t, d, ff) + mm(t, ff, d)
        q_rows = seq if kind == "train" else 1
        return lin, 2 * mm(b * hq * q_rows, hd, kv_len)  # QK^T and PV

    def mamba():
        s = cfg.ssm
        d_in = s.expand * d
        h, p, n = d_in // s.head_dim, s.head_dim, s.state_dim
        lin = mm(t, d, 2 * d_in + 2 * n + h) + mm(t, d_in, d)
        if kind == "train":
            nc, L = seq // s.chunk_size, s.chunk_size
            lin += _einsum_flops("bctn,bcun->bctu", (b, nc, L, n), (b, nc, L, n))
            lin += _einsum_flops("bctuh,bcuhp->bcthp", (b, nc, L, L, h), (b, nc, L, h, p))
            lin += _einsum_flops("bcuh,bcuhp,bcun->bchpn", (b, nc, L, h), (b, nc, L, h, p), (b, nc, L, n))
            lin += _einsum_flops("bctn,bchpn->bcthp", (b, nc, L, n), (b, nc, h, p, n))
        else:
            conv_ch = d_in + 2 * n
            lin += _einsum_flops("bkc,kc->bc", (b, s.conv_width, conv_ch), (s.conv_width, conv_ch))
            lin += _einsum_flops("bh,bhp,bn->bhpn", (b, h), (b, h, p), (b, n))
            lin += _einsum_flops("bn,bhpn->bhp", (b, n), (b, h, p, n))
        return lin

    lin, attn = mm(t, d, v), 0  # the logits
    if cfg.family == "hybrid":
        n_attn = -(-cfg.num_layers // cfg.attn_every)
        lin += cfg.num_layers * mamba()
        blk, a = block()
        lin, attn = lin + n_attn * blk, n_attn * a
    else:
        blk, a = block()
        lin, attn = lin + cfg.num_layers * blk, cfg.num_layers * a
    per_rank = 3 * lin + 7 * attn // 2 if kind == "train" else lin + attn
    return per_rank * data * model


MINI = [(arch, kind) for arch in ("olmo-1b", "zamba2-1.2b") for kind in ("train", "decode")]


def _mini(arch, kind):
    cfg = get_smoke_config(arch)
    with fake_mesh((2, 4)) as mesh:
        cell = cells.lower_cell(arch, ShapeConfig("mini", 32, 4, kind), mesh, cfg_override=cfg)
    return cfg, cell


@pytest.mark.parametrize("arch, kind", MINI)
def test_miniature_dryrun_counts_each_product_once(arch, kind):
    cfg, cell = _mini(arch, kind)
    want = _closed_form(cfg, kind, 4, 32, 2, 4)
    got = cell.cost.flops * 8
    assert abs(got - want) <= REL * want, (got, want)
    assert cell.cost.peak > 0 and cell.arg_bytes > 0
    # Every collective the islands need is a DTensor redistribution or a
    # functional collective the meter saw.
    assert sum(cell.cost.coll_breakdown.values()) > 0


def test_run_cell_on_the_production_mesh():
    """One production cell through ``run_cell`` on a 256-rank fake group:
    the reference's record keys, H100 terms, and the closed form's scale."""
    from repro_torch.launch import dryrun

    with fake_process_group(256):
        rec = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False, verbose=False)
    keys = {"arch", "shape", "kind", "mesh", "chips", "status", "lower_s", "compile_s",
            "bytes_per_device", "gb_per_device", "hlo_flops", "hlo_bytes", "collective_bytes",
            "collective_breakdown", "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "flops_source", "model_flops", "useful_flops_ratio", "roofline_fraction",
            "params", "active_params", "global_batch", "seq_len"}
    assert keys <= set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["chips"] == 256
    cfg = get_config("olmo-1b")
    assert rec["hlo_flops"] == pytest.approx(_closed_form(cfg, "decode", 128, 32768, 16, 16), rel=REL)
    assert rec["t_compute_s"] == pytest.approx(rec["hlo_flops"] / (256 * 989e12))


def test_report_tables_equal_reference():
    records = [
        {"arch": "olmo-1b", "shape": "train_4k", "mesh": "16x16", "status": "ok", "compile_s": 12.5,
         "gb_per_device": 3.25, "bytes_per_device": 3.49e9, "t_compute_s": 0.0123, "t_memory_s": 1.5,
         "t_collective_s": 0.0009, "bottleneck": "memory", "useful_flops_ratio": 0.812,
         "roofline_fraction": 0.0082},
        {"arch": "yi-9b", "shape": "prefill_32k", "mesh": "16x16", "status": "ok", "compile_s": 3.0,
         "gb_per_device": 20.0, "bytes_per_device": 2.2e10, "t_compute_s": 2.5, "t_memory_s": 0.25,
         "t_collective_s": 0.75, "bottleneck": "compute", "useful_flops_ratio": 0.5,
         "roofline_fraction": 1.0},
        {"arch": "yi-9b", "shape": "decode_32k", "mesh": "2x16x16", "status": "FAIL: ValueError: x"},
        {"arch": "yi-9b", "shape": "long_500k", "status": "skipped: pure full attention: O(S^2) at 524k"},
    ]
    assert report.dryrun_table(records, 16 * 2**30, "16G") == jreport.dryrun_table(records)
    assert report.roofline_table(records) == jreport.roofline_table(records)
    assert report.pick_hillclimb(records) == jreport.pick_hillclimb(records)
    assert "fits 80G" in report.dryrun_table(records)


def _reference_counts() -> None:
    """The reference's XLA FLOPs for the miniature cells beside the port's
    trace (``python tests/test_torch_dryrun.py``; needs 8 host devices)."""
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.roofline import analyze_compiled
    from repro.configs.registry import get_smoke_config as jax_smoke

    mesh = make_debug_mesh(2, 4)
    for arch, kind in MINI:
        name = {"train": "train_4k", "decode": "decode_32k"}[kind]
        JAX_SHAPES[name] = dataclasses.replace(JAX_SHAPES[name], seq_len=32, global_batch=4)
        jl = jcells.lower_cell(arch, name, mesh, cfg_override=jax_smoke(arch))
        xla = analyze_compiled(jl.lowered.compile(), 8).flops
        cfg, cell = _mini(arch, kind)
        print(f"{arch} {kind}: port trace {cell.cost.flops * 8:.6g}, closed form "
              f"{_closed_form(cfg, kind, 4, 32, 2, 4):.6g}, reference XLA {xla:.6g}")


if __name__ == "__main__":
    sys.exit(_reference_counts())
