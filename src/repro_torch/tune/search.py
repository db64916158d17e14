"""Search drivers: device-sharded grid sweep, random search, successive halving.

The analytic objectives (utilization and area) are closed-form arithmetic,
so the grid sweep evaluates them *on device*: design points are encoded as
a ``[P, 6]`` feature matrix, padded to a multiple of the device count and
cut into equal contiguous shards, one per device of the list ``tune_mesh``
returns (the CUDA devices, or CPU devices in the tests); each device
evaluates its shard with the torch function ``_eval_features``.  This is
the counterpart of the reference's ``shard_map`` over a 1-D "tune" mesh
axis.  The per-device shard counts come back with the metrics so tests (and
the report) can verify the sharding actually happened.  Accuracy depends
only on (N, segments, protocol seq), so it is joined host-side from the
``objectives`` cache — one evaluation per distinct combination, not per
point; its Fig. 12 part runs on ``device``.

``random_search`` samples a fixed-size subspace deterministically from a
seed; ``successive_halving`` ranks on a scalarized score and re-evaluates
survivors at increasing accuracy fidelity (longer Table 2 sequences), the
classic multi-fidelity bandit over the same evaluators.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.systolic_model import PAPER_SEQLENS, baseline_utilization

from .design import SCHEDULES, DesignPoint, exact_fit_point
from .objectives import eval_accuracy

__all__ = [
    "SweepResult",
    "tune_mesh",
    "encode_points",
    "grid_space",
    "grid_sweep",
    "random_search",
    "scalar_score",
    "successive_halving",
]

_FEATURES = ("array_n", "single_direction", "pwl_segments", "spad_kib",
             "accum_kib", "freq_ghz")
_METRICS = ("mean_util", "mean_tflops", "peak_tflops", "cycles_max_seq",
            "std_um2", "fsa_additional_um2", "array_um2", "sram_um2",
            "total_um2", "overhead_pct")


@dataclasses.dataclass
class SweepResult:
    records: list[dict]
    per_device_counts: list[int]  # design points evaluated on each device

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)


def tune_mesh(num_devices: Optional[int] = None, device: str = "cuda") -> list[torch.device]:
    """The local devices the design points are sharded over: every CUDA
    device (at most ``num_devices``), or ``num_devices`` CPU devices (one by
    default) for ``device="cpu"``."""
    kind = torch.device(device).type
    if kind == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("tune_mesh: no CUDA device")
        return devices[:num_devices] if num_devices is not None else devices
    if kind == "cpu":
        return [torch.device("cpu")] * (num_devices or 1)
    raise ValueError(f"tune_mesh: no mesh for device {device!r}")


def encode_points(points: Sequence[DesignPoint]) -> np.ndarray:
    """[P, 6] float32 feature rows in ``_FEATURES`` order."""
    return np.asarray(
        [
            (
                p.array_n,
                1.0 if p.single_direction else 0.0,
                p.pwl_segments,
                p.spad_kib,
                p.accum_kib,
                p.freq_ghz,
            )
            for p in points
        ],
        np.float32,
    )


def _eval_features(feats: torch.Tensor) -> torch.Tensor:
    """[p, 6] fp32 features -> [p, len(_METRICS)] fp32 metrics, on the
    features' device.

    Same closed forms and order of operations as the reference's function
    and as ``objectives.eval_performance`` / ``eval_area`` (§3.5 cycle
    counts, Table 3 component model); equality with both is pinned in
    tests/test_torch_tune.py.
    """
    from .objectives import (
        FREQ_AREA_SLOPE,
        PAPER_AREA,
        PAPER_N,
        SPLIT_LUT_FRACTION,
        SRAM_UM2_PER_KIB,
    )

    n = feats[:, 0]
    sd = feats[:, 1]
    segs = feats[:, 2]
    spad = feats[:, 3]
    accum = feats[:, 4]
    freq = feats[:, 5]

    seqs = torch.tensor(PAPER_SEQLENS, dtype=torch.float32, device=feats.device)[None, :]  # [1, S]
    nc = n[:, None]
    tiles = torch.ceil(seqs / nc)  # Tr = Tc
    tile_cycles = (5.0 * n + 10.0 + n * sd)[:, None]
    cycles = tiles * tiles * tile_cycles + tiles * (2.0 * n + 20.0)[:, None]
    flops = 4.0 * seqs * seqs * nc
    peak_per_cycle = 2.0 * nc * nc
    util = flops / (cycles * peak_per_cycle)
    mean_util = util.mean(dim=1)
    peak_tflops = 2.0 * n * n * freq * 1e-3  # 2N^2 FLOPs/cycle at freq GHz
    cycles_max = cycles[:, -1]

    per_pe = PAPER_AREA["pes"] / (PAPER_N * PAPER_N)
    per_up = PAPER_AREA["upward"] / (PAPER_N * PAPER_N)
    per_split = PAPER_AREA["split"] / (PAPER_N * PAPER_N)
    per_cmp = PAPER_AREA["cmp"] / PAPER_N
    freq_scale = 1.0 + FREQ_AREA_SLOPE * (freq - 1.5)
    std = (per_pe * n * n + PAPER_AREA["other"]) * freq_scale
    split = per_split * n * n * (
        1.0 - SPLIT_LUT_FRACTION + SPLIT_LUT_FRACTION * segs / 8.0
    )
    upward = (1.0 - sd) * per_up * n * n
    add = (split + upward + per_cmp * n) * freq_scale
    sram = (spad + accum) * SRAM_UM2_PER_KIB

    return torch.stack(
        [
            mean_util,
            mean_util * peak_tflops,
            peak_tflops,
            cycles_max,
            std,
            add,
            std + add,
            sram,
            std + add + sram,
            100.0 * add / (std + add),
        ],
        dim=1,
    )


def _sharded_metrics(
    feats: np.ndarray, devices: Sequence[torch.device]
) -> tuple[np.ndarray, list[int]]:
    """Evaluate the feature matrix in equal contiguous shards, one per
    device; the metrics and the count of real (unpadded) rows per device."""
    num = feats.shape[0]
    ndev = len(devices)
    pad = (-num) % ndev
    if pad:
        # Pad with copies of the first row: harmless math, masked out below.
        feats = np.concatenate([feats, np.repeat(feats[:1], pad, axis=0)])
    valid = (np.arange(feats.shape[0]) < num).astype(np.float32)
    rows = feats.shape[0] // ndev

    metrics, counts = [], []
    for i, dev in enumerate(devices):
        shard = slice(i * rows, (i + 1) * rows)
        metrics.append(_eval_features(torch.from_numpy(feats[shard]).to(dev)).cpu().numpy())
        counts.append(int(valid[shard].sum()))
    return np.concatenate(metrics)[:num], counts


def grid_sweep(
    points: Sequence[DesignPoint],
    *,
    mesh=None,
    accuracy_seq: int = 2048,
    seed: int = 0,
    device: str = "cuda",
) -> SweepResult:
    """Evaluate every point; analytic objectives sharded over ``mesh``, a
    list of devices from ``tune_mesh``.

    With ``mesh=None`` the same vectorized evaluator runs on ``device``
    (per_device_counts == [len(points)]).  Accuracy (Table 2 / Fig. 12) is
    joined from the host-side cache, one evaluation per distinct
    (N, segments), its Fig. 12 sweep on ``device``; baseline speedups
    likewise per distinct N.
    """
    points = list(points)
    for p in points:
        p.validate()
    feats = encode_points(points)
    if mesh is not None:
        metrics, counts = _sharded_metrics(feats, mesh)
    else:
        metrics = _eval_features(torch.from_numpy(feats).to(device)).cpu().numpy()
        counts = [len(points)]

    base_means: dict[int, dict[str, float]] = {}
    records = []
    for point, row in zip(points, metrics):
        rec = {"label": point.label(), **dataclasses.asdict(point)}
        rec.update({k: float(v) for k, v in zip(_METRICS, row)})
        n = point.array_n
        if n not in base_means:
            base_means[n] = {
                which: float(
                    np.mean([baseline_utilization(which, s, n) for s in PAPER_SEQLENS])
                )
                for which in ("tpu_v5e", "neuron_v2")
            }
        rec["speedup_vs_tpu_v5e"] = rec["mean_util"] / base_means[n]["tpu_v5e"]
        rec["speedup_vs_neuron_v2"] = rec["mean_util"] / base_means[n]["neuron_v2"]
        rec.update(eval_accuracy(point, seq=accuracy_seq, seed=seed, device=device))
        records.append(rec)
    return SweepResult(records=records, per_device_counts=counts)


# ---------------------------------------------------------------------------
# Space constructors
# ---------------------------------------------------------------------------

def grid_space(
    *,
    array_ns: Sequence[int] = (64, 128, 256),
    schedules: Sequence[str] = SCHEDULES,
    segments: Sequence[int] = (4, 8, 16),
    sram_overs: Sequence[int] = (1,),
    freqs: Sequence[float] = (1.5,),
) -> list[DesignPoint]:
    """Cartesian product of the axes, invalid points filtered out.

    SRAM is specified as an over-provisioning factor on the exact-fit
    capacity (the paper point is exact-fit at N=128), so every array size
    gets a buildable memory system; the paper's 192+64 KiB appears as
    ``array_ns=(128,), sram_overs=(1,)``.
    """
    out = []
    for n in array_ns:
        for sched in schedules:
            for k in segments:
                for over in sram_overs:
                    for f in freqs:
                        p = exact_fit_point(
                            n, schedule=sched, pwl_segments=k,
                            freq_ghz=f, sram_over=over,
                        )
                        if p.is_valid():
                            out.append(p)
    return out


def random_search(
    num_points: int,
    *,
    seed: int = 0,
    array_ns: Sequence[int] = (32, 64, 128, 256),
    schedules: Sequence[str] = SCHEDULES,
    segments: Sequence[int] = (2, 4, 8, 16, 32),
    sram_overs: Sequence[int] = (1, 2),
    freqs: Sequence[float] = (0.75, 1.0, 1.5, 2.0),
    mesh=None,
    accuracy_seq: int = 2048,
    device: str = "cuda",
) -> SweepResult:
    """Deterministically sample ``num_points`` distinct valid points."""
    rng = np.random.default_rng(seed)
    seen: set[DesignPoint] = set()
    points: list[DesignPoint] = []
    attempts = 0
    while len(points) < num_points and attempts < num_points * 100:
        attempts += 1
        p = exact_fit_point(
            int(rng.choice(array_ns)),
            schedule=str(rng.choice(schedules)),
            pwl_segments=int(rng.choice(segments)),
            freq_ghz=float(rng.choice(freqs)),
            sram_over=int(rng.choice(sram_overs)),
        )
        if p.is_valid() and p not in seen:
            seen.add(p)
            points.append(p)
    return grid_sweep(points, mesh=mesh, accuracy_seq=accuracy_seq, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Successive halving
# ---------------------------------------------------------------------------

def scalar_score(rec: dict, *, w_area: float = 0.5, w_acc: float = 5.0) -> float:
    """Fixed scalarization used only to *rank* within successive halving.

    Normalizes area by the paper total so the terms are O(1); higher is
    better.  The Pareto frontier (pareto.py) is the real multi-objective
    output — this score just decides which points graduate to the next
    fidelity rung.
    """
    from .objectives import PAPER_TARGETS

    return (
        rec["mean_util"]
        - w_area * rec["total_um2"] / PAPER_TARGETS["area_total_um2"]
        - w_acc * rec["acc_mre"]
    )


def successive_halving(
    points: Sequence[DesignPoint],
    *,
    seed: int = 0,
    eta: int = 2,
    fidelities: Sequence[int] = (256, 1024, 2048),
    mesh=None,
    device: str = "cuda",
) -> SweepResult:
    """Multi-fidelity search: rank at short Table 2 sequences, promote the
    top 1/eta to longer ones; survivors end fully evaluated at the final
    fidelity.  Deterministic given (points, seed)."""
    result = grid_sweep(
        points, mesh=mesh, accuracy_seq=fidelities[0], seed=seed, device=device
    )
    survivors = list(zip(points, result.records))
    for fidelity in fidelities[1:]:
        keep = max(1, -(-len(survivors) // eta))
        survivors.sort(key=lambda pr: scalar_score(pr[1]), reverse=True)
        survivors = survivors[:keep]
        for point, rec in survivors:
            rec.update(eval_accuracy(point, seq=fidelity, seed=seed, device=device))
    return SweepResult(
        records=[rec for _, rec in survivors],
        per_device_counts=result.per_device_counts,
    )
