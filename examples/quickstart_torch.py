"""Quickstart on the PyTorch port: the paper's technique in three views
(counterpart of ``examples/quickstart.py``).

1. SystolicAttention as a drop-in PyTorch attention (exact vs PWL-exp2
   numerics), on the card unless ``--device cpu``.
2. The FSA device simulator running the paper's Listing-2 kernel with
   cycle-exact §3.5 timing.
3. The Fig. 11 utilization models.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import figure11, naive_attention, systolic_attention
from repro_torch.core.fsa_flash import fsa_flash_attention
from repro_torch.core.systolic_model import fsa_attention_cycles


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    # 1. SystolicAttention as a PyTorch function --------------------------
    gen = torch.Generator(device=args.device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=args.device)

    q = randn(1, 256, 4, 64)
    k = randn(1, 256, 2, 64)  # GQA
    v = randn(1, 256, 2, 64)
    exact = systolic_attention(q, k, v, causal=True)
    pwl = systolic_attention(q, k, v, causal=True, exp2_impl="pwl")
    ref = naive_attention(q, k, v, causal=True)
    print(f"[1] exact-exp2 max err vs oracle: {float((exact - ref).abs().max()):.2e}")
    print(f"    PWL-exp2  max err vs oracle: {float((pwl - ref).abs().max()):.2e} "
          "(paper Table 2 envelope)")

    # 2. FSA device simulator (paper §4-5) ---------------------------------
    rng = np.random.default_rng(0)
    seq, d = 512, 128
    qs, ks, vs = (rng.standard_normal((seq, d)).astype(np.float16) for _ in range(3))
    res = fsa_flash_attention(qs, ks, vs)
    print(f"[2] FSA sim: {res.instr_count} instructions, {res.cycles} cycles "
          f"(closed form 5N+10 model: {fsa_attention_cycles(seq)}) "
          f"= {res.seconds() * 1e6:.1f} us at 1.5 GHz")

    # 3. Fig. 11 reproduction ----------------------------------------------
    fig = figure11()
    print(f"[3] Fig.11 mean utilization: FSA {fig['mean_fsa']:.3f} | "
          f"TPUv5e {fig['mean_tpu_v5e']:.3f} | Neuron-v2 {fig['mean_neuron_v2']:.3f}")
    print(f"    speedups {fig['speedup_vs_tpu_v5e']:.2f}x / "
          f"{fig['speedup_vs_neuron_v2']:.2f}x (paper: 1.77x / 4.83x)")


if __name__ == "__main__":
    main()
