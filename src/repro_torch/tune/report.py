"""Regenerable Pareto report: sweep -> frontier -> paper checks -> markdown.

``run_tune`` drives the whole subsystem: build a space (preset or custom),
evaluate it (mesh-sharded), extract the Pareto frontier, verify the
evaluators against the paper's published numbers at the paper's design
point, and spot-check frontier points end-to-end through the
instruction-level ``fsa_sim`` (cycle counts must equal the §3.5 closed
forms; numerics must stay inside the Table 2 envelope).  Everything is
deterministic given the seed — running twice produces byte-identical
JSON, so CI can regenerate and diff the report.

The special case ``preset="paper"`` evaluates exactly the paper's design
point, i.e. reproduces Fig. 11 / Table 2 / Table 3 on their own.

A copy of ``repro.tune.report`` whose ``run_tune`` takes ``device``: the
sweep's closed forms and its Fig. 12 PWL sweeps run there (the card by
default).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from repro_torch.core.fsa_flash import fsa_flash_attention
from repro_torch.core.systolic_model import fsa_attention_cycles

from .design import paper_point
from .objectives import PAPER_TARGETS, evaluate
from .pareto import OBJECTIVES, attach_frontier
from .search import (
    SweepResult,
    grid_space,
    grid_sweep,
    random_search,
    successive_halving,
    tune_mesh,
)

__all__ = ["PRESETS", "run_tune", "render_markdown", "write_report"]

# Grid axes + Table 2 protocol length per preset.  "paper" is the paper's
# single published point; "smoke" is the CI-sized sweep; "full" is the
# whole modelled space.
PRESETS = {
    "paper": dict(
        array_ns=(128,), schedules=("standard",), segments=(8,),
        sram_overs=(1,), freqs=(1.5,), accuracy_seq=2048,
    ),
    "smoke": dict(
        array_ns=(64, 128), schedules=("standard", "single_direction"),
        segments=(4, 8), sram_overs=(1,), freqs=(1.5,), accuracy_seq=256,
    ),
    "ci": dict(
        array_ns=(64, 128, 256), schedules=("standard", "single_direction"),
        segments=(4, 8, 16), sram_overs=(1, 2), freqs=(1.0, 1.5),
        accuracy_seq=512,
    ),
    "full": dict(
        array_ns=(32, 64, 128, 256), schedules=("standard", "single_direction"),
        segments=(2, 4, 8, 16, 32), sram_overs=(1, 2),
        freqs=(0.75, 1.0, 1.5, 2.0), accuracy_seq=2048,
    ),
}


def _paper_checks(accuracy_seq: int, device: str) -> tuple[dict, dict]:
    """Evaluate the paper point and compare against the published numbers."""
    rec = evaluate(paper_point(), accuracy_seq=accuracy_seq, device=device)
    t = PAPER_TARGETS

    def rel_ok(value, target, tol):
        return abs(value - target) <= tol * abs(target)

    checks = {
        "fig11_speedup_vs_tpu_v5e": {
            "value": rec["speedup_vs_tpu_v5e"], "target": t["speedup_vs_tpu_v5e"],
            "ok": rel_ok(rec["speedup_vs_tpu_v5e"], t["speedup_vs_tpu_v5e"], 0.02),
        },
        "fig11_speedup_vs_neuron_v2": {
            "value": rec["speedup_vs_neuron_v2"], "target": t["speedup_vs_neuron_v2"],
            "ok": rel_ok(rec["speedup_vs_neuron_v2"], t["speedup_vs_neuron_v2"], 0.02),
        },
        "table3_array_total_um2": {
            "value": rec["array_um2"], "target": t["area_total_um2"],
            "ok": rel_ok(rec["array_um2"], t["area_total_um2"], 1e-3),
        },
        "table3_overhead_pct": {
            "value": rec["overhead_pct"], "target": t["overhead_pct"],
            "ok": abs(rec["overhead_pct"] - t["overhead_pct"]) < 0.1,
        },
        "fig12_pwl_mre_8seg": {
            "value": rec["pwl_mre"], "target": t["pwl_mre_8seg"],
            "ok": rel_ok(rec["pwl_mre"], t["pwl_mre_8seg"], 0.05),
        },
        # Our simulator keeps fp32 inter-PE partial sums (the RTL quantizes
        # harder), so absolute Table 2 errors are smaller than the paper's;
        # the paper's worst-case envelope is the transferable bound.
        "table2_mae_envelope": {
            "value": rec["acc_mae"], "target": t["table2_mae_envelope"],
            "ok": rec["acc_mae"] <= t["table2_mae_envelope"],
        },
        "table2_mre_envelope": {
            "value": rec["acc_mre"], "target": t["table2_mre_envelope"],
            "ok": rec["acc_mre"] <= t["table2_mre_envelope"],
        },
    }
    return rec, checks


def _sim_cross_checks(records: list[dict], count: int) -> list[dict]:
    """Run >= ``count`` frontier points through the instruction-level sim.

    Validates the analytical model end to end: the simulated Listing-2
    kernel's cycle count must equal the §3.5 closed form for the point's
    array size and schedule variant, and its output must stay inside the
    Table 2 error envelope.
    """
    ordered = sorted(records, key=lambda r: (not r["on_frontier"], r["label"]))
    seen: set[tuple] = set()
    picked = []
    for rec in ordered:
        key = (rec["array_n"], rec["schedule"], rec["pwl_segments"])
        if key in seen:
            continue
        seen.add(key)
        picked.append(rec)
        if len(picked) >= count:
            break

    out = []
    for rec in picked:
        n = int(rec["array_n"])
        seq = 2 * n  # Tr = Tc = 2: exercises inner loop, rescale and drain
        single = rec["schedule"] == "single_direction"
        rng = np.random.default_rng((7, n, int(rec["pwl_segments"])))
        q, k, v = (rng.standard_normal((seq, n)).astype(np.float16) for _ in range(3))
        res = fsa_flash_attention(
            q, k, v,
            array_n=n,
            num_segments=int(rec["pwl_segments"]),
            single_direction=single,
            spad_bytes=int(rec["spad_kib"]) * 1024,
            # +4N B: the l row shares the sim's accum space but is held in
            # accumulator registers in the Table 1 capacity accounting.
            accum_bytes=int(rec["accum_kib"]) * 1024 + 4 * n,
        )
        model = fsa_attention_cycles(seq, n, n, single_direction=single)
        qf, kf, vf = (a.astype(np.float64) for a in (q, k, v))
        s = qf @ kf.T / np.sqrt(n)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        mae = float(np.abs(res.output - p @ vf).mean())
        out.append(
            {
                "label": rec["label"],
                "seq": seq,
                "cycles_sim": int(res.cycles),
                "cycles_model": int(model),
                "cycles_ok": int(res.cycles) == int(model),
                "mae": mae,
                "mae_ok": mae <= PAPER_TARGETS["table2_mae_envelope"],
                "on_frontier": bool(rec["on_frontier"]),
            }
        )
    return out


def run_tune(
    preset: str = "smoke",
    *,
    search: str = "grid",
    seed: int = 0,
    mesh=True,
    num_points: int = 32,
    accuracy_seq: Optional[int] = None,
    paper_check_seq: int = 2048,
    sim_check_count: int = 3,
    device: str = "cuda",
) -> dict:
    """Full autotune pass; returns the report payload (JSON-serializable).

    ``mesh=True`` shards the sweep over ``tune_mesh(device=device)``,
    ``False`` evaluates it on ``device`` alone, and a list of devices is
    used as it is.
    """
    spec = dict(PRESETS[preset])
    acc_seq = accuracy_seq if accuracy_seq is not None else spec.pop("accuracy_seq")
    spec.pop("accuracy_seq", None)

    if mesh is True:
        mesh = tune_mesh(device=device)
    elif mesh is False:
        mesh = None
    ndev = len(mesh) if mesh is not None else 1

    if search == "grid":
        points = grid_space(**spec)
        result: SweepResult = grid_sweep(
            points, mesh=mesh, accuracy_seq=acc_seq, seed=seed, device=device
        )
    elif search == "random":
        result = random_search(
            num_points, seed=seed, mesh=mesh, accuracy_seq=acc_seq,
            array_ns=spec["array_ns"], schedules=spec["schedules"],
            segments=spec["segments"], sram_overs=spec["sram_overs"],
            freqs=spec["freqs"], device=device,
        )
    elif search == "sha":
        points = grid_space(**spec)
        fidelities = tuple(sorted({min(256, acc_seq), max(acc_seq // 2, 256), acc_seq}))
        result = successive_halving(
            points, seed=seed, mesh=mesh, fidelities=fidelities, device=device
        )
    else:
        raise ValueError(f"unknown search driver: {search!r}")

    records = result.records
    front = attach_frontier(records)
    paper_rec, checks = _paper_checks(paper_check_seq, device)

    # Where does the paper's point sit?  (It is in every grid preset; for
    # random/sha it may not have been sampled.)
    paper_label = paper_point().label()
    swept_paper = next((r for r in records if r["label"] == paper_label), None)
    paper_on_frontier = bool(swept_paper and swept_paper["on_frontier"])

    sim_checks = _sim_cross_checks(records, sim_check_count)

    frontier = sorted(
        (records[i] for i in front), key=lambda r: -r["mean_tflops"]
    )
    return {
        "preset": preset,
        "search": search,
        "seed": seed,
        "accuracy_seq": acc_seq,
        "mesh_devices": ndev,
        "per_device_counts": result.per_device_counts,
        "num_points": len(records),
        "frontier_size": len(front),
        "paper_point_in_sweep": swept_paper is not None,
        "paper_on_frontier": paper_on_frontier,
        "paper": {
            k: paper_rec[k]
            for k in (
                "mean_util", "mean_tflops", "speedup_vs_tpu_v5e",
                "speedup_vs_neuron_v2", "array_um2", "total_um2",
                "overhead_pct", "acc_mae", "acc_mre", "pwl_mae", "pwl_mre",
            )
        },
        "paper_checks": checks,
        "paper_checks_ok": all(c["ok"] for c in checks.values()),
        "sim_checks": sim_checks,
        "sim_checks_ok": bool(sim_checks)
        and all(c["cycles_ok"] and c["mae_ok"] for c in sim_checks),
        "objectives": [list(o) for o in OBJECTIVES],
        "frontier": frontier,
        "records": records,
    }


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _fmt(v, nd=3):
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or abs(v) < 1e-3:
            return f"{v:.2e}"
        return f"{v:.{nd}f}"
    return str(v)


def render_markdown(report: dict) -> str:
    lines = [
        "# FSA design-space autotune report",
        "",
        f"- preset `{report['preset']}`, search `{report['search']}`, "
        f"seed {report['seed']}, Table 2 protocol seq {report['accuracy_seq']}",
        f"- {report['num_points']} design points over "
        f"{report['mesh_devices']} device(s); per-device shard counts "
        f"{report['per_device_counts']}",
        f"- Pareto objectives: "
        + ", ".join(f"{k} ({d})" for k, d in report["objectives"]),
        "",
        "## Paper design point vs published numbers",
        "",
        "| check | value | paper | ok |",
        "|---|---|---|---|",
    ]
    for name, c in report["paper_checks"].items():
        lines.append(
            f"| {name} | {_fmt(float(c['value']))} | {_fmt(float(c['target']))} "
            f"| {_fmt(bool(c['ok']))} |"
        )
    where = (
        "on the Pareto frontier"
        if report["paper_on_frontier"]
        else "NOT on the frontier"
        if report["paper_point_in_sweep"]
        else "not in this sweep"
    )
    lines += [
        "",
        f"The paper's 128x128 / 8-segment / 192+64 KiB point is **{where}** "
        "of this sweep.",
        "",
        "## Pareto frontier",
        "",
        "| design | util | TFLOP/s | area mm^2 | overhead % | Table2 MRE "
        "| vs TPUv5e | vs Neuron-v2 |",
        "|---|---|---|---|---|---|---|---|",
    ]
    paper_label = paper_point().label()
    for r in report["frontier"]:
        star = " *" if r["label"] == paper_label else ""
        lines.append(
            f"| {r['label']}{star} | {r['mean_util']:.3f} "
            f"| {r['mean_tflops']:.1f} | {r['total_um2'] / 1e6:.2f} "
            f"| {r['overhead_pct']:.2f} | {r['acc_mre']:.2e} "
            f"| {r['speedup_vs_tpu_v5e']:.2f}x | {r['speedup_vs_neuron_v2']:.2f}x |"
        )
    lines += [
        "",
        "(* = the paper's design point)",
        "",
        "## Instruction-level simulator cross-checks",
        "",
        "| design | seq | sim cycles | model cycles | cycles ok | MAE | ok |",
        "|---|---|---|---|---|---|---|",
    ]
    for c in report["sim_checks"]:
        lines.append(
            f"| {c['label']} | {c['seq']} | {c['cycles_sim']} "
            f"| {c['cycles_model']} | {_fmt(c['cycles_ok'])} "
            f"| {c['mae']:.2e} | {_fmt(c['mae_ok'])} |"
        )
    lines += [
        "",
        "Cycle counts from the functional simulator's §3.5 timeline must "
        "equal the closed-form model; output MAE must stay inside the "
        "paper's Table 2 envelope (3.4e-2).  Absolute errors are below the "
        "paper's RTL because the simulator keeps fp32 inter-PE partial sums.",
        "",
    ]
    return "\n".join(lines)


def write_report(
    report: dict,
    md_path: Optional[str] = None,
    json_path: Optional[str] = None,
) -> None:
    """Persist the report; strips the full record list from the JSON so the
    benchmark summary stays headline-sized (the frontier is kept)."""
    if md_path:
        with open(md_path, "w") as f:
            f.write(render_markdown(report))
    if json_path:
        payload = {k: v for k, v in report.items() if k != "records"}
        with open(json_path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
