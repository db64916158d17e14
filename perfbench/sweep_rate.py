"""Finds a serving cell's knee: the highest arrival rate its open loop
sustains with no growing queue.

    python3 perfbench/sweep_rate.py --workload olmo-1b.serve.chat --rates 4 6 8 10 12 --seconds 30

Runs the cell's traffic mix at each rate in turn, in one process on one
card, the same seed each time, and prints one JSON line a rate: the backlog
(requests due and not yet in prefill) at the window's open and close and
its growth per second, the window's TTFT and ITL p95, output tokens/s and
whether the output check held.  The cell's file keeps the rate it runs at
as a number; this script does not write it.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.run import _environment, forbidden_modules  # noqa: E402

_environment()

from perfbench.harness import bench, serve  # noqa: E402


def backlog(records, t: float) -> int:
    return sum(1 for r in records if r.due <= t and (r.t_prefill is None or r.t_prefill > t))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_rate: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    for rate in args.rates:
        c = copy.deepcopy(cell)
        c.traffic["rate_per_s"] = rate
        t0 = time.perf_counter()
        run, numbers, peak, attempted, failed = serve.run(c, args.seed, args.seconds, False, "cuda", t0)
        checks = {name: (numbers[name], limit) for name, limit in c.limits.items()}
        w0, w1 = run.window
        b0, b1 = backlog(run.requests, w0), backlog(run.requests, w1)
        read = {m: bench.reader(m)(run) for m in ("ttft_p95_ms", "itl_p95_ms", "output_tokens_per_s")}
        print(json.dumps({"rate_per_s": rate, "backlog_open": b0, "backlog_close": b1,
                          "backlog_growth_per_s": (b1 - b0) / run.window_s, "attempted": attempted,
                          "failed": failed, **read, "correct": all(v <= lim for v, lim in checks.values()),
                          "checks": {k: v for k, (v, _) in checks.items()}, "memory_peak_bytes": peak,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        del run
    if forbidden_modules():
        print(f"sweep_rate: loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
