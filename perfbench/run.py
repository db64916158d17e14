"""Runs one benchmark cell once and prints its result as the last line.

    python3 perfbench/run.py --workload olmo-1b.serve.chat --seed 7 --seconds 40 --trace 0

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; ``perfbench/harness/bench.py`` finds
their files and each metric's reader by name.  ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, the device
trace's busy and window seconds and a breakdown.  Every run checks what the
timed path produced against the plain reference (``perfbench/reference``)
and prints each compared number beside its limit on standard error and
under ``checks`` in the result.  It needs as many CUDA devices as the cell
asks for, and imports no JAX.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """One run of ``cell`` (a ``bench.Cell``): the result's dict, with
    ``memory_peak_bytes`` and the trace's seconds where ``device`` goes."""
    from perfbench.harness import bench, profiling, serve, train

    loop = train if cell.traffic["loop"] == "train" else serve
    run, numbers, memory_peak, attempted, failed = loop.run(cell, seed, seconds, trace, device, T_PROCESS)
    checks = {name: (numbers[name], limit) for name, limit in cell.limits.items()}
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = bench.reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    correct = all(value <= limit for value, limit in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "memory_peak_bytes": memory_peak}
    if trace and run.trace is not None:
        result["busy_s"], result["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        result["breakdown"] = profiling.breakdown(run.trace)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench.harness import bench

    cell = bench.load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if "busy_s" in result:
        device["busy_s"], device["window_s"] = result.pop("busy_s"), result.pop("window_s")
    result["device"] = device
    result["checks"] = result.pop("checks")  # the compared numbers come last
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
