"""A rank of tests/test_torch_dist.py's gloo runs (started by
``python -m torch.distributed.run --standalone``; imports no JAX).

  forward DIR ARCH...   for each ARCH: DIR/ARCH.npz (flat "/"-joined param
                        paths) and DIR/ARCH.tokens.npy -> the forward on a
                        2 x 2 mesh, rank 0 writes DIR/ARCH.out.npy; for
                        yi-9b also a checkpoint of the placed params,
                        restored and rescaled onto 4 x 1, one training step
                        there, and psum_mean of the ranks over "data" ->
                        DIR/yi-9b.rescale.json
  int8 DIR CASE...      for each ARCH:QUANT:DxM case: the forward of
                        DIR/ARCH.npz on DIR/ARCH.tokens.npy under the quant
                        flag QUANT on a D x M mesh; rank 0 writes
                        DIR/ARCH.QUANT.DxM.out.npy; then each kind of split
                        int8 product on the 4 ranks against int8_dot of the
                        whole operands -> DIR/int8_products.json, and yi-9b's
                        loss and gradients with remat under each int8 policy
                        on 2 x 2 and 1 x 4 against one process's ->
                        DIR/int8_grads.json
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import apply_rescale, batch_pspec, param_shardings, place, rescale_plan, set_mesh
from repro_torch.dist import pipelined_apply
from repro_torch.dist.collectives import full, psum_mean
from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh, parse_mesh
from repro_torch.models import model as tm
from repro_torch.optim import compressed_pmean
from repro_torch.quant import int8_dot
from repro_torch.quant.quantize import Split
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.train.train_step import make_train_step, value_and_grad


def load_params(path: Path) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(np.array(z[key]))
    return tree


def full_tree(tree):
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(full_tree(v) for v in tree))
    return full(tree)


def smoke_config(arch: str, quant=None):
    """The smoke config; a MoE one at capacity_factor 16 (drops nothing)."""
    cfg = get_smoke_config(arch, quant)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


def sharded_forward(out_dir: Path, arch: str, cfg, mesh, name: str):
    """The forward of DIR/ARCH.npz on DIR/ARCH.tokens.npy under ``mesh``;
    rank 0 writes DIR/NAME.out.npy.  Returns (placed params, tokens)."""
    params = load_params(out_dir / f"{arch}.npz")
    toks = torch.from_numpy(np.load(out_dir / f"{arch}.tokens.npy"))
    placed = place(params, param_shardings(params, cfg, mesh))
    with set_mesh(mesh), torch.no_grad():
        out = full(tm.forward(placed, cfg, tokens=toks))
    if dist.get_rank() == 0:
        np.save(out_dir / f"{name}.out.npy", out.numpy())
    return placed, toks


def forward(out_dir: Path, archs: list) -> None:
    ensure_process_group(4, "cpu")
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    for arch in archs:
        cfg = smoke_config(arch)
        placed, toks = sharded_forward(out_dir, arch, cfg, mesh, arch)
        if arch == "yi-9b":
            rescale(out_dir, cfg, placed, toks)


def int8(out_dir: Path, cases: list) -> None:
    ensure_process_group(4, "cpu")
    for case in cases:
        arch, quant, shape = case.split(":")
        mesh = make_debug_mesh(*parse_mesh(shape), device_type="cpu")
        sharded_forward(out_dir, arch, smoke_config(arch, quant), mesh, f"{arch}.{quant}.{shape}")
    int8_products(out_dir)
    int8_grads(out_dir)


def int8_grads(out_dir: Path) -> None:
    """yi-9b (remat on) under int8 on 2 x 2 and int8-per-tensor on 1 x 4:
    |loss - one process's loss| and the largest |gradient difference|."""
    params = load_params(out_dir / "yi-9b.npz")
    toks = torch.from_numpy(np.load(out_dir / "yi-9b.tokens.npy"))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    errors = {}
    for quant, shape in (("int8", (2, 2)), ("int8-per-tensor", (1, 4))):
        cfg = dataclasses.replace(get_smoke_config("yi-9b", quant), remat=True)
        want_loss, want = value_and_grad(cfg, params, batch)
        mesh = make_debug_mesh(*shape, device_type="cpu")
        with set_mesh(mesh):
            loss, got = value_and_grad(cfg, place(params, param_shardings(params, cfg, mesh)),
                                       place(batch, batch_pspec(batch, mesh, cfg)))
        errors[quant] = dict(
            loss=abs(float(full(loss)) - float(want_loss)),
            grad=max(float((full(a) - b).abs().max()) for a, b in zip(tree_leaves(got), tree_leaves(want))))
    if dist.get_rank() == 0:
        (out_dir / "int8_grads.json").write_text(json.dumps(errors))


def int8_products(out_dir: Path) -> None:
    """x [6, 64] @ w [64, 32] split 4 ways, each rank's product against
    the whole one's part, as max |difference| (0 is bit for bit): the
    output of a contraction split (and x's and w's gradient shards), of a
    column split over the group and of a column slice of a whole weight,
    per channel and per tensor."""
    rank, group = dist.get_rank(), dist.group.WORLD
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 64, generator=g)
    w = torch.randn(64, 32, generator=g) / 8
    c = torch.randn(6, 32, generator=g)
    rows, cols = slice(16 * rank, 16 * rank + 16), slice(8 * rank, 8 * rank + 8)
    errors = {}
    for per_channel in (True, False):
        kind = "per_channel" if per_channel else "per_tensor"
        xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = int8_dot(xw, ww, per_channel=per_channel)
        gx, gw = torch.autograd.grad((want * c).sum(), (xw, ww))
        xl, wl = x[:, rows].clone().requires_grad_(), w[rows].clone().requires_grad_()
        got = int8_dot(xl, wl, per_channel=per_channel, split=Split("contraction", group))
        gxl, gwl = torch.autograd.grad((got * c).sum(), (xl, wl))
        errors[f"contraction/{kind}"] = float((got - want).abs().max())
        errors[f"contraction/{kind}/dx"] = float((gxl - gx[:, rows]).abs().max())
        errors[f"contraction/{kind}/dw"] = float((gwl - gw[rows]).abs().max())
        got = int8_dot(x, w[:, cols], per_channel=per_channel, split=Split("columns", group))
        errors[f"columns/{kind}"] = float((got - want[:, cols]).abs().max())
        got = int8_dot(x, w[:, cols], per_channel=per_channel, split=Split("columns", whole=w))
        errors[f"slice/{kind}"] = float((got - want[:, cols]).abs().max())
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, errors)
    if rank == 0:
        (out_dir / "int8_products.json").write_text(json.dumps(gathered))


def rescale(out_dir: Path, cfg, placed: dict, toks: torch.Tensor) -> None:
    """Checkpoint the 2 x 2 params as full tensors, restore them, re-place
    them on a 4 x 1 mesh by a rescale plan and take one step there."""
    rank = dist.get_rank()
    ckpt = CheckpointManager(str(out_dir / "ckpt"))
    opt = AdamW(lr=1e-3)
    state = {"params": full_tree(placed), "opt": opt.init(full_tree(placed))}
    if rank == 0:
        ckpt.save(1, state)
    dist.barrier()
    restored = ckpt.restore(1, state)
    new_mesh = make_debug_mesh(4, 1, device_type="cpu")
    pshapes = tm.param_shapes(cfg)
    plan = rescale_plan(cfg, pshapes, opt.init(pshapes), new_mesh, old_devices=4)
    placed = apply_rescale(restored, {"params": plan.param_shardings, "opt": plan.opt_shardings})
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    batch = place(batch, batch_pspec(batch, new_mesh))
    with set_mesh(new_mesh), torch.no_grad():
        loss = float(full(tm.lm_loss(placed["params"], cfg, batch)))
        new_params, _, _ = make_train_step(cfg, opt)(placed["params"], placed["opt"], batch)
    sums = [float(full(x).double().sum()) for x in tree_leaves(new_params)]
    mean = psum_mean(torch.tensor([float(rank)]), "data", new_mesh)  # ranks 0..3 on "data"
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, sums)
    if rank == 0:
        (out_dir / "yi-9b.rescale.json").write_text(json.dumps({
            "loss": loss,
            "old_devices": plan.old_devices,
            "new_devices": plan.new_devices,
            "params_equal_across_ranks": all(g == sums for g in gathered),
            "psum_mean_of_ranks": float(mean),
        }))


def _stage(w, x):
    return torch.tanh(x @ w)


def _sequential_with_grads(ws, x, c):
    ws, x = ws.clone().requires_grad_(), x.clone().requires_grad_()
    out = x
    for i in range(ws.shape[0]):
        out = _stage(ws[i], out)
    return (out.detach(), *torch.autograd.grad((out * c).sum(), (ws, x)))


def pipeline(out_dir: Path) -> None:
    """``pipelined_apply`` at 4 and 2 stages against the sequential
    schedule, forward and gradient, with plain and DTensor weights."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    ensure_process_group(4, "cpu")
    rank = dist.get_rank()
    z = np.load(out_dir / "pipeline.npz")
    x, c = torch.from_numpy(z["x"]), torch.from_numpy(z["c"])
    saved, errors = {}, {}
    for stages, shape, names in ((4, (4,), ("pod",)), (2, (2, 2), ("pod", "data"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        ws = torch.from_numpy(z[f"ws{stages}"])
        seq, gw_seq, gx_seq = _sequential_with_grads(ws, x, c)
        w_plain = ws.clone().requires_grad_()
        w_dt = distribute_tensor(ws.clone(), mesh, [Shard(0)] + [Replicate()] * (len(shape) - 1)).requires_grad_()
        for kind, w in (("plain", w_plain), ("dtensor", w_dt)):
            xg = x.clone().requires_grad_()
            with set_mesh(mesh):
                out = pipelined_apply(lambda p, h: _stage(p["w"], h), {"w": w}, xg,
                                      num_stages=stages, num_microbatches=4)
            gw, gx = torch.autograd.grad((out * c).sum(), (w, xg))
            errors[f"{kind}{stages}"] = dict(
                out=float((out - seq).abs().max()), grad_w=float((full(gw) - gw_seq).abs().max()),
                grad_x=float((gx - gx_seq).abs().max()))
            if kind == "plain":
                saved[f"out{stages}"] = out.detach().numpy()
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, errors)
    if rank == 0:
        np.savez(out_dir / "pipeline.out.npz", **saved)
        (out_dir / "pipeline.json").write_text(json.dumps(gathered))


def pmean(out_dir: Path) -> None:
    """``compressed_pmean`` of rank-distinct gradients over "data"."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(4, "cpu")
    rank = dist.get_rank()
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    z = np.load(out_dir / "pmean.npz")
    leaves = sorted({k.split("/")[1] for k in z.files})
    grads = {n: torch.from_numpy(z[f"g/{n}/{rank}"]) for n in leaves}
    residual = {n: torch.from_numpy(z[f"r/{n}/{rank}"]) for n in leaves}
    avg, new_r = compressed_pmean(grads, residual, "data", mesh)
    np.savez(out_dir / f"pmean.{rank}.npz", **{f"avg/{n}": avg[n].numpy() for n in leaves},
             **{f"r/{n}": new_r[n].numpy() for n in leaves})


if __name__ == "__main__":
    modes, out_dir, *rest = sys.argv[1:]
    for mode in modes.split(","):
        if mode == "forward":
            forward(Path(out_dir), rest)
        elif mode == "int8":
            int8(Path(out_dir), rest)
        elif mode == "pipeline":
            pipeline(Path(out_dir))
        elif mode == "pmean":
            pmean(Path(out_dir))
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    dist.destroy_process_group()
