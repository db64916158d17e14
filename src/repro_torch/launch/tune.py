"""FSA design-space autotune launcher (counterpart of ``repro.launch.tune``).

  PYTHONPATH=src python -m repro_torch.launch.tune --preset smoke --seed 0
  PYTHONPATH=src python -m repro_torch.launch.tune --preset smoke --device cpu

Runs the ``repro_torch.tune`` subsystem end to end: builds the preset's
design space, evaluates it sharded over the local devices (the CUDA cards by
default), extracts the Pareto frontier over (TFLOP/s, area, Table 2 error),
cross-checks the evaluators against the paper's published numbers and
spot-checks frontier points through the instruction-level simulator. The
Fig. 12 PWL sweeps run through the PWL exp2 kernel on the card.
Deterministic given ``--seed``: re-running regenerates byte-identical JSON.

  --preset paper|smoke|ci|full   design space (paper = the single
                                 published point, i.e. Fig. 11 + Table 2
                                 + Table 3 as the special case)
  --search grid|random|sha       exhaustive sweep / random sample /
                                 successive halving (multi-fidelity)
  --no-mesh                      evaluate on one device (no sharding)
  --accuracy-seq N               override the Table 2 protocol length
  --device cuda|cpu              where the sweep runs (default cuda)

The report and its JSON go under ``build/`` by default, apart from the
reference's committed ``tune_report.md`` and ``BENCH_tune.json``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="smoke",
                    choices=("paper", "smoke", "ci", "full"))
    ap.add_argument("--search", default="grid", choices=("grid", "random", "sha"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=32,
                    help="sample size for --search random")
    ap.add_argument("--accuracy-seq", type=int, default=None)
    ap.add_argument("--paper-check-seq", type=int, default=2048)
    ap.add_argument("--sim-checks", type=int, default=3)
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="build/repro_torch_tune/tune_report.md",
                    help="markdown report path")
    ap.add_argument("--json", default="build/repro_torch_tune/BENCH_tune.json",
                    help="JSON payload path")
    args = ap.parse_args()

    from repro_torch.tune import render_markdown, run_tune, write_report

    report = run_tune(
        args.preset,
        search=args.search,
        seed=args.seed,
        mesh=not args.no_mesh,
        num_points=args.points,
        accuracy_seq=args.accuracy_seq,
        paper_check_seq=args.paper_check_seq,
        sim_check_count=args.sim_checks,
        device=args.device,
    )
    for path in (args.out, args.json):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_report(report, md_path=args.out, json_path=args.json)
    print(render_markdown(report))
    print(f"wrote {args.out} and {args.json}")
    if not (report["paper_checks_ok"] and report["sim_checks_ok"]):
        raise SystemExit("paper/sim cross-checks FAILED — see report")


if __name__ == "__main__":
    main()
