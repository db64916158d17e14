"""Paper Listing 2, verbatim shape, on the PyTorch port's copy of the FSA
programming model (counterpart of ``examples/fsa_kernel_demo.py``): a custom
FlashAttention kernel written against the FSA Python programming model (§5)
and executed on the instruction-level device simulator (numpy, on the host)
with §3.5 cycle accounting.  The exact softmax reference is computed in
fp64 by PyTorch on ``--device``.

Run:  PYTHONPATH=src python examples/fsa_kernel_demo_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import repro_torch.core.fsa_kernel_api as F
from repro_torch.core.systolic_model import fsa_attention_cycles


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    seq, d = 512, 128
    br = bc = 128
    scale = 1.0 / np.sqrt(d)
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((seq, d)).astype(np.float16)
    K = rng.standard_normal((seq, d)).astype(np.float16)
    V = rng.standard_normal((seq, d)).astype(np.float16)
    Vt_host = np.ascontiguousarray(V.T)  # host-side pre-transpose (§5.3)

    # Accumulation SRAM holds one fp32 O tile + the log-expsum row
    # (128*128*4 + 128*4 = 64 KiB + 512 B; Table 1 rounds to 64 KiB).
    @F.kernel(device="fsa_sim", accum_bytes=d * br * 4 + br * 4)
    def attention(Qm: F.MTile, Km: F.MTile, Vt: F.MTile) -> F.MTile:
        Ot = F.alloc_mem((d, seq), np.float32, name="Ot")
        Ot_tiles = Ot.split(br, dim=-1)
        Q_tiles = Qm.split(br, dim=-2)
        K_tiles = Km.split(bc, dim=-2)
        Vt_tiles = Vt.split(bc, dim=-1)

        Q_s = (F.alloc_spad((br, d)), F.alloc_spad((br, d)))
        K_s = (F.alloc_spad((bc, d)), F.alloc_spad((bc, d)))
        V_s = (F.alloc_spad((d, bc)), F.alloc_spad((d, bc)))
        log_expsum = F.alloc_accum((1, br))
        O_acc = F.alloc_accum((d, br))

        for i, Q_i in enumerate(Q_tiles):
            F.load_tile(Q_i, Q_s[i % 2])
            dev = F._ctx().device
            O_acc._write(dev.accum, np.zeros(O_acc.shape, np.float32))
            log_expsum._write(dev.accum, np.zeros(log_expsum.shape, np.float32))
            for j, (K_j, Vt_j) in enumerate(zip(K_tiles, Vt_tiles)):
                F.load_stationary(Q_s[i % 2], transpose=True, reset_stats=(j == 0))
                F.load_tile(K_j, K_s[j % 2])
                F.attn_score(K_s[j % 2], log_expsum, scale=scale)
                F.load_tile(Vt_j, V_s[j % 2])
                F.attn_value(V_s[j % 2], O_acc)
            F.reciprocal(log_expsum)
            F.attn_lse_norm(O_acc)
            F.store_tile(O_acc, Ot_tiles[i])
        return Ot

    res = attention(Q, K, Vt_host)
    O = res.output.T  # host-side transpose back

    # Exact reference, in fp64 on the device.
    q, k, v = (torch.from_numpy(t.astype(np.float64)).to(args.device) for t in (Q, K, V))
    ref = (torch.softmax(q @ k.T * scale, dim=-1) @ v).cpu().numpy()

    print(f"instructions: {res.instr_count}   cycles: {res.cycles} "
          f"(5N+10 model: {fsa_attention_cycles(seq)})")
    print(f"MAE vs exact SDPA: {np.abs(O - ref).mean():.2e}")
    print("program head:", res.program.instrs[:6])


if __name__ == "__main__":
    main()
