"""A rank of tests/test_torch_dist.py's gloo runs (started by
``python -m torch.distributed.run --standalone``; imports no JAX).

  forward DIR ARCH...   for each ARCH: DIR/ARCH.npz (flat "/"-joined param
                        paths) and DIR/ARCH.tokens.npy -> the forward on a
                        2 x 2 mesh, rank 0 writes DIR/ARCH.out.npy; for
                        yi-9b also a checkpoint of the placed params,
                        restored and rescaled onto 4 x 1, one training step
                        there, and psum_mean of the ranks over "data" ->
                        DIR/yi-9b.rescale.json
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
from repro_torch.dist.collectives import full, psum_mean
from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh
from repro_torch.models import model as tm
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.train.train_step import make_train_step


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


def forward(out_dir: Path, archs: list) -> None:
    ensure_process_group(4, "cpu")
    rank = dist.get_rank()
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    for arch in archs:
        cfg = get_smoke_config(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        params = load_params(out_dir / f"{arch}.npz")
        toks = torch.from_numpy(np.load(out_dir / f"{arch}.tokens.npy"))
        placed = place(params, param_shardings(params, cfg, mesh))
        with set_mesh(mesh), torch.no_grad():
            out = full(tm.forward(placed, cfg, tokens=toks))
        if rank == 0:
            np.save(out_dir / f"{arch}.out.npy", out.numpy())
        if arch == "yi-9b":
            rescale(out_dir, cfg, placed, toks)


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


if __name__ == "__main__":
    mode, out_dir, *rest = sys.argv[1:]
    if mode == "forward":
        forward(Path(out_dir), rest)
    dist.destroy_process_group()
