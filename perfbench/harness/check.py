"""The comparisons that decide ``correct``; the reference is
``perfbench/reference``, which imports nothing of the program.

Serving: for each sampled request the reference runs once over the prompt
and the tokens the program served (teacher-forced, float32), and the
numbers are the widest and the mean gap by which a served token's logit
lies below the reference's best logit at that position, and the share of
served tokens that are not the reference's argmax.  Greedy decoding serves
the argmax, so a correct program reads rounding only.  A cell compares the
numbers its ``cells/<cell>.json`` gives a limit; a serving run also counts
the requests due in the window with no first token, the sampled ones
served fewer tokens than asked, and the samples short of the mix's
``check.requests`` (``harness/serve.py``), each held at 0.

Training: ``train_numbers`` compares what the program's first steps
produced with the reference's three steps from the same weights and
batches: each step's loss, each leaf's gradient as the optimizer got it at
step 1 (the gap of its norm and the norm of its difference), and the norm
of each leaf's change over three steps.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref


@torch.no_grad()
def reference_logits(params: dict, m: dict, prompt, out, bucket_for) -> torch.Tensor:
    """The reference's float32 logits at the positions that predict each
    served token, teacher-forced over the prompt and the served tokens."""
    plen = len(prompt)
    toks = torch.as_tensor(np.concatenate([prompt, out[:-1]]).astype(np.int64), device=params["embed"].device)
    cap_rows = plen if m.get("moe") is not None else 0
    return ref.forward(params, m, toks, cap_rows, bucket_for(plen) if cap_rows else 0, first_row=plen - 1)


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """At each position of ``logits`` [n, V], the gap by which the logit of
    ``tokens`` [n] lies below the best."""
    return logits.max(dim=-1).values - logits.gather(1, tokens[:, None].to(logits.device))[:, 0]


def summarize_gaps(parts: list) -> dict:
    """The widest and the mean gap over all positions of ``parts``, and the
    share (%) of positions whose token is not the reference's argmax."""
    gap = torch.cat(parts) if parts else torch.zeros(1)
    return {"logit_gap": float(gap.max()), "logit_gap_mean": float(gap.mean()),
            "argmax_mismatch": 100.0 * float((gap > 0).float().mean())}


def served_logit_gaps(params: dict, m: dict, samples: list, bucket_for) -> dict:
    """The served tokens of ``samples`` [(prompt, served tokens)] against
    the reference: ``summarize_gaps``."""
    parts = []
    for prompt, out in samples:
        logits = reference_logits(params, m, prompt, out, bucket_for)
        parts.append(gaps(logits, torch.as_tensor(out)))
        del logits
    return summarize_gaps(parts)


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's |program norm - reference norm|, against the larger
    of that leaf's reference norm and the median leaf's; ``keep`` names the
    leaves compared (default: all)."""
    names = [k for k in reference if keep is None or k in keep]
    median = float(np.median([reference[k] for k in names]))
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in names)


def leaf_diff(program: dict, reference: dict, ref_norms: dict) -> float:
    """The worst leaf's norm of (program - reference), against the larger
    of that leaf's reference norm and the median leaf's."""
    median = float(np.median([ref_norms[k] for k in reference]))
    worst = 0.0
    for k in reference:
        r = reference[k]
        diff = float(torch.linalg.vector_norm(program[k].to(r.device).float() - r.float()))
        worst = max(worst, diff / max(ref_norms[k], median))
    return worst


def train_numbers(program: dict, reference: dict) -> dict:
    """``program``/``reference``: {"losses": [3], "grad"/"change": {leaf:
    norm}, "grad_t": {leaf: tensor}}.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change.

    ``*_gap`` compare norms (the gap of the program's norm and the
    reference's); ``grad_diff`` the norm of the difference, which is first
    order in an error that a gap of norms sees at second order only."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    grad_median = float(np.median(list(reference["grad"].values())))
    moving = {k for k, g in reference["grad"].items() if g >= 1e-3 * grad_median}
    return {
        "loss_gap": max(losses),
        "grad_gap": leaf_gap(program["grad"], reference["grad"]),
        "change_gap": leaf_gap(program["change"], reference["change"], moving),
        "grad_diff": leaf_diff(program["grad_t"], reference["grad_t"], reference["grad"]),
    }
