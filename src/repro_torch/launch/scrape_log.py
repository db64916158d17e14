"""Recover structured records from run logs (a copy of
``repro.launch.scrape_log``).

Two sources, newest first:

  * **JSONL fast path** — the trainer (``TrainerConfig.metrics_jsonl``,
    wired to ``launch/train.py --metrics-out``) streams one JSON object
    per step; any log whose lines parse as JSON objects is consumed
    verbatim, no regexes.
  * **Regex fallback** — dryrun stdout logs (for runs interrupted before
    their JSON dump) are scraped with the original pattern set.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.scrape_log run_log.txt out.json
"""

from __future__ import annotations

import json
import re
import sys


def scrape_jsonl(text: str) -> list[dict]:
    """Collect every line that parses as a JSON object (the trainer's
    metrics stream; interleaved non-JSON lines — human log lines, tracebacks
    — are skipped)."""
    records = []
    for line in text.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            records.append(obj)
    return records


def scrape_dryrun(text: str) -> list[dict]:
    """Regex path: reconstruct dryrun records from stdout."""
    records = []
    cur = None
    for line in text.splitlines():
        m = re.match(r"== (\S+) x (\S+) on (\S+) \((\d+) chips\) ==", line)
        if m:
            if cur:
                records.append(cur)
            cur = {
                "arch": m.group(1),
                "shape": m.group(2),
                "mesh": m.group(3),
                "chips": int(m.group(4)),
                "status": "ok",
            }
            continue
        if cur is None:
            continue
        m = re.search(r"lower ([\d.]+)s compile ([\d.]+)s", line)
        if m:
            cur["lower_s"], cur["compile_s"] = float(m.group(1)), float(m.group(2))
        m = re.search(r"per-device bytes: ([\d.]+) GiB", line)
        if m:
            cur["gb_per_device"] = float(m.group(1))
            cur["bytes_per_device"] = int(float(m.group(1)) * 2**30)
        m = re.search(
            r"compute ([\d.]+) ms \| memory ([\d.]+) ms \| collective ([\d.]+) ms -> (\w+)-bound",
            line,
        )
        if m:
            cur["t_compute_s"] = float(m.group(1)) / 1e3
            cur["t_memory_s"] = float(m.group(2)) / 1e3
            cur["t_collective_s"] = float(m.group(3)) / 1e3
            cur["bottleneck"] = m.group(4)
        m = re.search(
            r"MODEL_FLOPS/HLO_FLOPS = ([\d.]+)\s+roofline fraction = ([\d.]+)", line
        )
        if m:
            cur["useful_flops_ratio"] = float(m.group(1))
            cur["roofline_fraction"] = float(m.group(2))
    if cur:
        records.append(cur)
    return records


def scrape(text: str) -> list[dict]:
    """JSONL fast path when the log carries structured records, else the
    dryrun regex fallback."""
    records = scrape_jsonl(text)
    return records if records else scrape_dryrun(text)


def main() -> None:
    src, dst = sys.argv[1], sys.argv[2]
    with open(src, errors="replace") as f:
        records = scrape(f.read())
    with open(dst, "w") as f:
        json.dump(records, f, indent=1)
    print(f"scraped {len(records)} records -> {dst}")


if __name__ == "__main__":
    main()
