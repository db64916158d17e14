"""repro_torch.core's FSA hardware models against repro.core's.

``systolic_model``, ``fsa_sim``, ``fsa_kernel_api`` and ``fsa_flash`` are
numpy in both packages, so on the same seeded inputs every result is equal
exactly: cycle counts, utilizations, Fig. 11 dicts, and simulator outputs
bit for bit.
"""

import numpy as np
import pytest

from repro.core import fsa_flash as ref_flash
from repro.core import fsa_kernel_api as ref_api
from repro.core import fsa_sim as ref_sim
from repro.core import systolic_model as ref_model
from repro_torch.core import fsa_flash, fsa_kernel_api, fsa_sim, systolic_model

SEQLENS = (128, 512, 2048, 5000, 16384)


@pytest.mark.parametrize("seqlens", [systolic_model.PAPER_SEQLENS, (512, 1000, 3000)])
def test_figure11_equal(seqlens):
    assert systolic_model.figure11(seqlens=seqlens) == ref_model.figure11(seqlens=seqlens)


def test_reference_fig11_pairing_is_kept():
    """The reference's targets (1.77x vs TPUv5e, 4.83x vs Neuron-v2), not
    the abstract's pairing."""
    fig = systolic_model.figure11()
    assert fig["paper_speedup_vs_tpu_v5e"] == 1.77
    assert fig["paper_speedup_vs_neuron_v2"] == 4.83
    assert fig["speedup_vs_tpu_v5e"] == pytest.approx(1.77, rel=0.01)


@pytest.mark.parametrize("single_direction", [False, True])
@pytest.mark.parametrize("n", [32, 64, 128, 256])
def test_cycle_and_utilization_models_equal(n, single_direction):
    assert systolic_model.fsa_tile_cycles(n, single_direction=single_direction) == \
        ref_model.fsa_tile_cycles(n, single_direction=single_direction)
    assert systolic_model.naive_tile_cycles(n) == ref_model.naive_tile_cycles(n)
    assert systolic_model.matmul_cycles(3 * n, n) == ref_model.matmul_cycles(3 * n, n)
    assert systolic_model.fsa_rescale_cycles(n) == ref_model.fsa_rescale_cycles(n)
    for s in SEQLENS:
        args = (s, n, n)
        assert systolic_model.fsa_attention_cycles(*args, single_direction=single_direction) == \
            ref_model.fsa_attention_cycles(*args, single_direction=single_direction)
        assert systolic_model.fsa_utilization(*args, single_direction=single_direction) == \
            ref_model.fsa_utilization(*args, single_direction=single_direction)
        assert systolic_model.attention_flops(s, n) == ref_model.attention_flops(s, n)
        for which in ("tpu_v5e", "neuron_v2"):
            assert systolic_model.baseline_utilization(which, s, n) == \
                ref_model.baseline_utilization(which, s, n)


@pytest.mark.parametrize("num_segments", [2, 8, 64])
def test_simulator_pwl_equal(num_segments):
    rng = np.random.default_rng(0)
    x = np.concatenate([-np.abs(rng.standard_normal(20_000)) * 30.0,
                        np.linspace(-152.0, -118.0, 2001)]).astype(np.float32)
    ours = fsa_sim._pwl_exp2_np(x, num_segments)
    np.testing.assert_array_equal(ours.view(np.int32),
                                  ref_sim._pwl_exp2_np(x, num_segments).view(np.int32))


def _qkv(seq, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((seq, n)).astype(np.float16) for _ in range(3))


@pytest.mark.parametrize("single_direction", [False, True])
@pytest.mark.parametrize("n", [64, 128])
def test_fsa_flash_attention_equal(n, single_direction):
    """The paper's Listing 2 on both simulators: equal outputs, cycles and
    instruction streams."""
    q, k, v = _qkv(2 * n, n, seed=n)
    kw = dict(array_n=n, num_segments=8, single_direction=single_direction,
              spad_bytes=12 * n * n, accum_bytes=4 * n * n + 4 * n)
    ours = fsa_flash.fsa_flash_attention(q, k, v, **kw)
    ref = ref_flash.fsa_flash_attention(q, k, v, **kw)
    np.testing.assert_array_equal(ours.output, ref.output)
    assert (ours.cycles, ours.instr_count) == (ref.cycles, ref.instr_count)
    assert [repr(i) for i in ours.program.instrs] == [repr(i) for i in ref.program.instrs]


def _one_tile_program(sim, n, num_segments, single_direction):
    """One Q tile against two K/V tiles, written instruction by instruction
    (§4.2), run on ``sim``'s FSADevice: (outputs in main memory, cycles)."""
    q, k, v = _qkv(2 * n, n, seed=3)
    dev = sim.FSADevice(array_n=n, num_segments=num_segments,
                        single_direction=single_direction)
    dev.main.update(q=q[:n], k0=k[:n], k1=k[n:], vt0=v[:n].T.copy(), vt1=v[n:].T.copy())
    dev.alloc("accum", "l", (1, n), np.float32)
    dev.alloc("accum", "o", (n, n), np.float32)
    prog = sim.FSAProgram()
    prog.emit("load_tile", src="q", dst="sq")
    for j in range(2):
        prog.emit("load_stationary", tile="sq", transpose=True, reset_stats=(j == 0))
        prog.emit("load_tile", src=f"k{j}", dst=f"sk{j}")
        prog.emit("attn_score", k=f"sk{j}", l="l", scale=1.0 / np.sqrt(n))
        prog.emit("load_tile", src=f"vt{j}", dst=f"sv{j}")
        prog.emit("attn_value", v=f"sv{j}", o="o")
    prog.emit("reciprocal", l="l")
    prog.emit("attn_lse_norm", o="o")
    prog.emit("store_tile", src="o", dst="out")
    prog.emit("store_tile", src="l", dst="l_out")
    dev.run(prog)
    return dev.main, dev.cycles


@pytest.mark.parametrize("num_segments,single_direction", [(8, False), (4, True)])
def test_simulator_program_equal(num_segments, single_direction):
    """One program's outputs and cycles on both simulators."""
    ours, ours_cycles = _one_tile_program(fsa_sim, 64, num_segments, single_direction)
    ref, ref_cycles = _one_tile_program(ref_sim, 64, num_segments, single_direction)
    assert ours_cycles == ref_cycles
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key])


def _split_store_kernel(F):
    """A kernel through the §5 API: nested split views and a store through
    them (tests/test_fsa_kernel_api.py's first case)."""
    base = np.arange(32, dtype=np.float32).reshape(4, 8)

    @F.kernel()
    def k():
        m = F.alloc_mem((4, 8), np.float32, data=base)
        quads = m.split(4, dim=-1)[1].split(2, dim=0)
        a = F.alloc_accum((2, 4))
        a._write(F._ctx().device.accum, np.full((2, 4), 7.0, np.float32))
        F.store_tile(a, quads[1])
        return m

    return k()


def test_kernel_api_equal():
    ours, ref = _split_store_kernel(fsa_kernel_api), _split_store_kernel(ref_api)
    np.testing.assert_array_equal(ours.output, ref.output)
    assert (ours.cycles, ours.instr_count) == (ref.cycles, ref.instr_count)
    assert [repr(i) for i in ours.program.instrs] == [repr(i) for i in ref.program.instrs]
