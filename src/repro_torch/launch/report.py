"""Render the dry-run's JSON records into the Dry-run / Roofline markdown
tables (counterpart of ``repro.launch.report``; plain Python).

  PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json

"fits" reads a device's memory, the H100's 80 GB by default.
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(b: float) -> str:
    if b >= 2**30:
        return f"{b / 2**30:.2f}G"
    if b >= 2**20:
        return f"{b / 2**20:.1f}M"
    return f"{b / 2**10:.0f}K"


def fmt_t(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    return f"{s * 1e3:.1f}ms"


HBM_BYTES = 80e9  # H100 80GB HBM3 (launch.roofline.HBM_BYTES)


def dryrun_table(records: list[dict], hbm_bytes: float = HBM_BYTES, label: str = "80G") -> str:
    lines = [
        f"| arch | shape | mesh | compile | GiB/dev | fits {label} | status |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r.get('mesh','-')} | - | - | - | {r['status']} |"
            )
            continue
        fits = "yes" if r["bytes_per_device"] < hbm_bytes else "**over**"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compile_s']}s "
            f"| {r['gb_per_device']} | {fits} | ok |"
        )
    return "\n".join(lines)


def roofline_table(records: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | t_compute | t_memory | t_collective | bound | 6ND/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("status") != "ok":
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_t(r['t_compute_s'])} | {fmt_t(r['t_memory_s'])} "
            f"| {fmt_t(r['t_collective_s'])} | {r['bottleneck']} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


def pick_hillclimb(records: list[dict]) -> list[dict]:
    ok = [r for r in records if r.get("status") == "ok" and r["mesh"] == "16x16"]
    if not ok:
        return []
    worst = min(ok, key=lambda r: r["roofline_fraction"])
    coll = max(ok, key=lambda r: r["t_collective_s"] / max(r["t_compute_s"], 1e-30))
    # most representative of the paper's technique: biggest attention share
    # ~ prefill of a big dense model
    prefill = [r for r in ok if r["shape"] == "prefill_32k"]
    rep = max(prefill, key=lambda r: r["t_compute_s"]) if prefill else worst
    out, seen = [], set()
    for r in (worst, coll, rep):
        key = (r["arch"], r["shape"])
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    records = json.load(open(path))
    print("### Dry-run table\n")
    print(dryrun_table(records))
    print("\n### Roofline table\n")
    print(roofline_table(records))
    print("\n### Hillclimb candidates\n")
    for r in pick_hillclimb(records):
        print(f"- {r['arch']} x {r['shape']}: bound={r['bottleneck']} "
              f"frac={r['roofline_fraction']:.3f}")


if __name__ == "__main__":
    main()
