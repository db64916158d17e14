"""Multi-pod dry-run: trace every (architecture x input shape) cell on the
production mesh and print its memory, cost and roofline analysis
(counterpart of ``repro.launch.dryrun``), on the CPU, without a device.

The mesh is a ``DeviceMesh`` over a fake process group of 256 ranks
(16 x 16) or 512 (2 x 16 x 16); the process traces rank 0's share of the
step on meta DTensors (``launch.cells.lower_cell``) under
``launch.roofline.CostMode`` and scales its FLOPs, bytes and collective
bytes by the device count.  The eager trace runs every layer, so the
reference's unroll-1/unroll-2 extrapolation is not needed.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --json out.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, runnable_cells, skipped_cells
from repro_torch.launch.cells import lower_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HBM_BYTES, analyze_trace, model_flops

# xLSTM's blocks run a Python loop over tokens, and an op on meta tensors
# costs ~0.3 ms of host time (64 tokens of train_4k traced in 120 s on one CPU core);
# a long sequence is traced at this many tokens and its FLOPs, bytes,
# collectives and activations scaled linearly.
SSM_TRACE_TOKENS = 16


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process is
    rank 0; collectives move no data), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    """Trace one cell on the production mesh (under a fake process group of
    its size, which the caller has made) -> the reference's record."""
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.size()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    flops_source = "eager trace, local shard shapes x devices (every layer counted)"
    scale = 1.0
    if cfg.family == "ssm" and shape.kind != "decode" and shape.seq_len > SSM_TRACE_TOKENS:
        scale = shape.seq_len / SSM_TRACE_TOKENS
        shape = dataclasses.replace(shape, seq_len=SSM_TRACE_TOKENS)
        flops_source += (f"; xLSTM's per-token loop traced at {SSM_TRACE_TOKENS} tokens,"
                         f" scaled x{scale:g}")

    t0 = time.time()
    cell = lower_cell(arch, shape, mesh, scan_unroll=1)
    t_lower = time.time() - t0

    terms = analyze_trace(cell.cost, chips)
    terms.flops *= scale
    terms.bytes_accessed *= scale
    terms.coll_bytes *= scale
    terms.coll_breakdown = {k: v * scale for k, v in terms.coll_breakdown.items()}
    bytes_per_device = cell.arg_bytes + cell.cost.peak * scale - cell.donated_bytes
    seq_len = int(cell.meta["seq_len"] * scale)
    tokens = cell.meta["global_batch"] * (seq_len if cell.kind in ("train", "prefill") else 1)
    mf = model_flops(cell.meta["active_params"], tokens, cell.kind)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": cell.mesh_desc,
        "chips": chips,
        "status": "ok",
        "lower_s": round(t_lower - cell.trace_s, 1),  # params, state and inputs placed
        "compile_s": round(cell.trace_s, 1),  # the step traced: the reference's compile
        "bytes_per_device": int(bytes_per_device),
        "gb_per_device": round(bytes_per_device / 2**30, 3),
        "hlo_flops": terms.flops,
        "hlo_bytes": terms.bytes_accessed,
        "collective_bytes": terms.coll_bytes,
        "collective_breakdown": terms.coll_breakdown,
        "t_compute_s": terms.t_compute,
        "t_memory_s": terms.t_memory,
        "t_collective_s": terms.t_collective,
        "bottleneck": terms.bottleneck,
        "flops_source": flops_source,
        "model_flops": mf,
        "useful_flops_ratio": mf / terms.flops if terms.flops else 0.0,
        "roofline_fraction": terms.roofline_fraction(),
        **cell.meta,
        "seq_len": seq_len,
    }
    if verbose:
        print(f"== {arch} x {shape_name} on {cell.mesh_desc} ({chips} devices) ==")
        print(f"  place {t_lower - cell.trace_s:.1f}s trace {cell.trace_s:.1f}s")
        print(
            f"  per-device bytes: {rec['gb_per_device']} GiB  "
            f"(H100 80GB: {'FITS' if bytes_per_device < HBM_BYTES else 'OVER'})"
        )
        print(
            f"  roofline terms: compute {terms.t_compute*1e3:.2f} ms | "
            f"memory {terms.t_memory*1e3:.2f} ms | "
            f"collective {terms.t_collective*1e3:.2f} ms -> {terms.bottleneck}-bound"
        )
        print(
            f"  MODEL_FLOPS/TRACE_FLOPS = {rec['useful_flops_ratio']:.3f}  "
            f"roofline fraction = {rec['roofline_fraction']:.3f}"
        )
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--start", type=int, default=0, help="skip first N cells")
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args()

    if args.all:
        cells = runnable_cells()[args.start:]
        if args.limit:
            cells = cells[: args.limit]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []

    def dump():
        if args.json:
            with open(args.json, "w") as f:
                json.dump(records, f, indent=1, default=str)

    t_all = time.time()
    for multi_pod in meshes:
        with fake_process_group(512 if multi_pod else 256):
            for arch, shape_name in cells:
                try:
                    records.append(run_cell(arch, shape_name, multi_pod))
                except Exception as e:  # a failure here is a sharding bug
                    traceback.print_exc()
                    records.append(
                        {
                            "arch": arch,
                            "shape": shape_name,
                            "mesh": "2x16x16" if multi_pod else "16x16",
                            "status": f"FAIL: {type(e).__name__}: {str(e)[:300]}",
                        }
                    )
                dump()  # incremental: survive interruption
    for arch, shape_name, reason in skipped_cells():
        records.append(
            {"arch": arch, "shape": shape_name, "status": f"skipped: {reason}"}
        )

    n_ok = sum(1 for r in records if r.get("status") == "ok")
    n_fail = sum(1 for r in records if str(r.get("status", "")).startswith("FAIL"))
    print(f"\n=== dry-run summary: {n_ok} ok, {n_fail} FAILED, "
          f"{len(records) - n_ok - n_fail} skipped, {time.time() - t_all:.1f}s ===")
    if args.json:
        dump()
        print(f"wrote {args.json}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
