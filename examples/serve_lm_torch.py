"""Serving example on the PyTorch port: batched request engine over prefill
+ KV-cache decode (counterpart of ``examples/serve_lm.py``).

A small dense LM serves a queue of batched requests; prefill runs the
SystolicAttention forward (on the card, the CUDA kernel; the compute-bound
phase the paper accelerates), decode the memory-bound cache path (paper
§8.3: FSA is *not* used for decode).  Greedy decoding of the same prompt
alone and in a batch verifies end-to-end determinism.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine

CFG = ModelConfig(
    name="demo-serve",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=1024,
    vocab_size=512,
    mlp_type="swiglu",
    dtype="float32",
    remat=False,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    params = init_params(CFG, 0, device=args.device)
    engine = ServeEngine(CFG, params, batch_size=4, max_len=64, device=args.device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=12).astype(np.int32) for _ in range(8)]
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=8))

    done = engine.run()
    assert len(done) == 8, f"expected 8 completions, got {len(done)}"
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} -> out={r.output}")
        assert len(r.output) == 8

    # Determinism: the same prompt yields the same greedy continuation.
    e2 = ServeEngine(CFG, params, batch_size=4, max_len=64, device=args.device)
    e2.submit(Request(rid=99, prompt=prompts[0], max_new_tokens=8))
    (r2,) = e2.run()
    match = r2.output == sorted(done, key=lambda r: r.rid)[0].output
    print("greedy determinism across batching:", match)
    assert match


if __name__ == "__main__":
    main()
