"""repro_torch's training path against repro's on bridged weights: lm_loss
and its gradients (dense, MoE, and under int8), remat, microbatches, the
AdamW and Adafactor updates, the schedules, the int8-compressed train step,
N steps of the Trainer, and checkpoint resume.  Smoke configs in fp32 on
the CPU; the same numpy batches go to both packages.

Tolerances (stated per check):
  * loss and each gradient leaf: 1e-5 of the leaf's largest |value| — both
    sides compute in fp32 and the matmul sums run in another order (the
    gap seen is ~1e-6);
  * the compressed step: loss and grad norm 1e-5 relative.  Where a
    gradient that differs by fp32 noise straddles a rounding point of the
    int8 grid, its payload lands one step apart on the two sides, so its
    residual differs by one step (at most 2 max|residual|) and its param by
    one more Adam step (at most 2 lr).  So: the residual within
    1e-5 of its leaf's gradient scale (at least 254 times its largest
    |value|) and the params within 1e-5 of each leaf's largest |value|,
    except at most max(2, 0.1%) elements a leaf, which must lie within
    those flip bounds;
  * optimizer updates: fp32 1e-6 relative (elementwise arithmetic only);
    bf16 params one bf16 step (the update is rounded to bf16 twice);
  * Trainer: step 1's loss and grad norm 1e-5 relative; later steps 1e-3
    relative, because Adam's first steps move every weight by about lr
    whatever its gradient, so weights whose gradient is fp32 noise move in
    directions that noise picks.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.bridge import params_from_jax, to_numpy  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.train.train_step import make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

GRAD_REL = 1e-5


def _bridged(arch, seed=0):
    """``arch`` or ``arch@quant-flag``: the smoke configs and bridged params."""
    arch, _, quant = arch.partition("@")
    jcfg, tcfg = jax_smoke_config(arch, quant or None), get_smoke_config(arch, quant or None)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _jax_flat(tree):
    return {
        "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assert_trees_close(ours, ref, rel=GRAD_REL, elementwise=False):
    """Each leaf within ``rel`` of the leaf's largest |ref|, or with
    ``elementwise`` each element within ``rel`` of its own |ref|."""
    ref = _jax_flat(ref)
    ours = {k: to_numpy(v) for k, v in _flatten_with_paths(ours).items()}
    assert set(ours) == set(ref)
    for key, r in ref.items():
        r = r.astype(np.float32)
        err = np.abs(ours[key].astype(np.float32) - r)
        scale = np.abs(r) if elementwise else max(float(np.abs(r).max()), 1e-30)
        assert (err <= rel * scale).all(), (key, float(err.max()))


def _lm_batch(vocab, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1  # masked out of the mean
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ["olmo-1b", "hubert-xlarge", "qwen3-moe-235b-a22b", "arctic-480b",
                                  "olmo-1b@int8", "qwen3-moe-235b-a22b@int8-per-tensor",
                                  "zamba2-1.2b"])
def test_lm_loss_and_grads_match_jax(arch):
    """olmo-1b: tokens, tied embeddings, causal.  hubert-xlarge: the encoder
    family, frame embeddings in, bidirectional attention, an untied head
    (its token embedding gets zero gradient on both sides).  qwen3-moe and
    arctic: capacity-bound routing (the router's gradient through the
    renormalised top-k probabilities; arctic's dense residual).  Under int8:
    straight-through gradients of the int8 projections and experts.
    zamba2: Mamba2 layers and the shared block, whose gradient sums its
    applications' (xlstm-125m: tests/test_torch_recurrent.py)."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    if arch == "hubert-xlarge":
        rng = np.random.default_rng(1)
        batch = {"embeds": rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32),
                 "labels": rng.integers(-1, jcfg.vocab_size, (2, 16)).astype(np.int32)}
    else:
        batch = _lm_batch(jcfg.vocab_size)
    jb, tb = _both(batch)
    ref_loss, ref_grads = jax.value_and_grad(jm.lm_loss)(jparams, jcfg, jb)
    loss, grads = value_and_grad(tcfg, tparams, tb)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=GRAD_REL)
    np.testing.assert_allclose(float(tm.lm_loss(tparams, tcfg, tb)), float(ref_loss), rtol=GRAD_REL)
    _assert_trees_close(grads, ref_grads)


def test_remat_gives_the_same_grads():
    """Recomputing each layer in the backward changes nothing: the recompute
    runs the same operations on the same inputs."""
    _, tcfg, _, tparams = _bridged("olmo-1b")
    _, tb = _both(_lm_batch(tcfg.vocab_size))
    loss, grads = value_and_grad(tcfg, tparams, tb)
    loss_r, grads_r = value_and_grad(dataclasses.replace(tcfg, remat=True), tparams, tb)
    assert float(loss) == float(loss_r)
    for a, b in zip(adamw.tree_leaves(grads), adamw.tree_leaves(grads_r)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_microbatches_match_full_batch_and_jax():
    """Two microbatches of a batch with no masked labels: the mean of the two
    means is the full batch's mean, and the gradients are fp32 averages.
    The step's loss and grad norm also match the reference's two-microbatch
    step."""
    jcfg, tcfg, jparams, tparams = _bridged("olmo-1b")
    batch = _lm_batch(jcfg.vocab_size, b=4)
    batch["labels"][0, :3] = batch["tokens"][0, 1:4]  # every label counts
    jb, tb = _both(batch)
    loss1, _ = value_and_grad(tcfg, tparams, tb)
    opt = adamw.AdamW(lr=1e-3)
    _, _, m1 = make_train_step(tcfg, opt)(tparams, opt.init(tparams), tb)
    _, _, m2 = make_train_step(tcfg, opt, num_microbatches=2)(tparams, opt.init(tparams), tb)
    np.testing.assert_allclose(float(m2["loss"]), float(loss1), rtol=GRAD_REL)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=GRAD_REL)

    jopt = jax_adamw.AdamW(lr=1e-3)
    jstep = jax_make_train_step(jcfg, jopt, num_microbatches=2)
    _, _, jm2 = jstep(jparams, jopt.init(jparams), jb)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), rtol=GRAD_REL)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jm2["grad_norm"]), rtol=GRAD_REL)


def _random_tree(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(name, dtype):
    """Two updates from the same params and gradients.  bf16 params: one bf16
    step of each element (at most 2**-7 of its value) — both sides round the
    update and the sum to bf16, and an fp32 update one ulp apart can round
    the other way."""
    jcfg = jax_smoke_config("olmo-1b")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jparams = jax.tree.map(lambda p: p.astype(jdt), jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    sched = 1e-2 if name == "adafactor" else 3e-3
    jopt = jax_adamw.make_optimizer(name, sched)
    topt = adamw.make_optimizer(name, sched)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for i in range(2):
        g = _random_tree(jparams, seed=i, scale=0.01)
        jg = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, jparams)
        tg = params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        jparams, jstate = jopt.update(jg, jstate, jparams)
        tparams, tstate = topt.update(tg, tstate, tparams)
    if dtype == "float32":
        _assert_trees_close(tparams, jparams, rel=1e-6)
    else:
        _assert_trees_close(tparams, jparams, rel=2.0 ** -7, elementwise=True)
    _assert_trees_close(tstate, jstate, rel=1e-5)
    assert int(tstate.step) == int(jstate.step) == 2


def test_schedules_match_jax():
    steps = [0, 1, 5, 10, 37, 100, 150]
    for jfn, tfn in (
        (jax_schedules.cosine_with_warmup(3e-4, 10, 100), schedules.cosine_with_warmup(3e-4, 10, 100)),
        (jax_schedules.linear_warmup_constant(1e-3, 7), schedules.linear_warmup_constant(1e-3, 7)),
    ):
        ref = [float(jfn(jnp.asarray(s, jnp.int32))) for s in steps]
        got = [float(tfn(torch.tensor(s, dtype=torch.int32))) for s in steps]
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert float(tfn(5)) == got[2]  # a Python int step works too


def test_compressed_train_step_matches_jax():
    """One int8-compressed step (AdamW) from the same params, batch and a
    nonzero residual, as a later step of a run sees it (the error feedback
    over several steps is held bit for bit in test_torch_quant.py; here
    more steps would compound the flips below through the params)."""
    jcfg, tcfg, jparams, tparams = _bridged("qwen3-moe-235b-a22b")
    jopt, topt = jax_adamw.AdamW(lr=1e-3), adamw.AdamW(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, compress_grads=True))
    tstep = make_train_step(tcfg, topt, compress_grads=True)
    rng = np.random.default_rng(3)
    residual = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-5).astype(np.float32), jparams)
    jb, tb = _both(_lm_batch(jcfg.vocab_size))
    *jout, jm_ = jstep(jparams, jopt.init(jparams), jb, jax.tree.map(jnp.asarray, residual))
    *tout, tm_ = tstep(tparams, topt.init(tparams), tb, params_from_jax(residual, "cpu"))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]), rtol=GRAD_REL)
    _assert_close_but_flips(tout[2], jout[2], 254 * GRAD_REL, lambda rmax: 2 * rmax)  # residual
    _assert_close_but_flips(tout[0], jout[0], GRAD_REL, lambda _: 2 * 1e-3)  # params


def _assert_close_but_flips(ours, ref, rel, flip_bound):
    """Each leaf within ``rel`` of its largest |ref|, but for at most
    max(2, 0.1%) elements within ``flip_bound(largest |ref|)``."""
    ours = {k: to_numpy(v) for k, v in _flatten_with_paths(ours).items()}
    for key, r in _jax_flat(ref).items():
        rmax = max(float(np.abs(r).max()), 1e-30)
        err = np.abs(ours[key] - r)
        off = err > rel * rmax
        assert off.sum() <= max(2, 1e-3 * off.size), (key, int(off.sum()), off.size)
        assert (err[off] <= flip_bound(rmax) + rel * rmax).all(), (key, float(err.max()), rmax)


def _trainer_cfg(tmp_path, name, **kw):
    base = dict(total_steps=4, ckpt_every=100, ckpt_dir=str(tmp_path / name),
                warmup_steps=2, log_every=100)
    base.update(kw)
    return base


def test_trainer_matches_jax_trainer(tmp_path):
    """Four steps of each Trainer from the same bridged params on the same
    SyntheticLM batches (seed 0)."""
    jcfg, tcfg, jparams, tparams = _bridged("olmo-1b")
    jnorms, tnorms = [], []
    jt = JaxTrainer(jcfg, JaxShapeConfig("t", 16, 2, "train"),
                    JaxTrainerConfig(**_trainer_cfg(tmp_path, "jax")),
                    hooks={"on_step": lambda s, m: jnorms.append(float(m["grad_norm"]))})
    jstate = jt.run({"params": jparams, "opt": jt.optimizer.init(jparams), "step": 0})
    tt = Trainer(tcfg, ShapeConfig("t", 16, 2, "train"), TrainerConfig(**_trainer_cfg(tmp_path, "torch")),
                 hooks={"on_step": lambda s, m: tnorms.append(float(m["grad_norm"]))}, device="cpu")
    tstate = tt.run({"params": tparams, "opt": tt.optimizer.init(tparams), "step": 0})
    assert tstate["step"] == jstate["step"] == 4
    np.testing.assert_allclose(tstate["losses"][0], jstate["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(tnorms[0], jnorms[0], rtol=1e-5)
    np.testing.assert_allclose(tstate["losses"], jstate["losses"], rtol=1e-3)
    np.testing.assert_allclose(tnorms, jnorms, rtol=1e-3)
    assert tt.registry.get("train_steps_total").value == 4


def test_checkpoint_resume_continues_the_loss_sequence(tmp_path):
    """A preempted run saves, a new Trainer resumes from that checkpoint, and
    the two together give the losses of one uninterrupted run; the
    retention policy keeps the newest ``keep`` checkpoints."""
    _, tcfg, _, _ = _bridged("olmo-1b")
    shape = ShapeConfig("t", 16, 2, "train")
    whole = Trainer(tcfg, shape, TrainerConfig(**_trainer_cfg(tmp_path, "whole", total_steps=6)),
                    device="cpu").run()

    kw = _trainer_cfg(tmp_path, "resumed", total_steps=6, ckpt_every=1, keep=2)

    def preempt_after_3(state, _metrics):
        if state["step"] == 3:
            first.preempt.trigger()

    first = Trainer(tcfg, shape, TrainerConfig(**kw), hooks={"on_step": preempt_after_3}, device="cpu")
    part1 = first.run()
    assert part1["step"] == 3 and first.ckpt.all_steps() == [2, 3]
    second = Trainer(tcfg, shape, TrainerConfig(**kw), device="cpu")
    part2 = second.run()
    assert part2["step"] == 6 and second.ckpt.all_steps() == [5, 6]
    # Bit-equal on the CPU: the restored state is the saved one, and every
    # operation is deterministic.
    assert part1["losses"] + part2["losses"] == whole["losses"]
    restored = second.ckpt.restore(6, {"params": part2["params"], "opt": part2["opt"]})
    for a, b in zip(adamw.tree_leaves(restored["params"]), adamw.tree_leaves(part2["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_compress_grads_resume_keeps_the_residual(tmp_path):
    """With compress_grads the residual is state: it is checkpointed, and a
    run preempted at step 2 and resumed gives the uninterrupted losses."""
    _, tcfg, _, _ = _bridged("olmo-1b")
    shape = ShapeConfig("t", 16, 2, "train")
    whole = Trainer(tcfg, shape, TrainerConfig(**_trainer_cfg(tmp_path, "whole", compress_grads=True)),
                    device="cpu").run()
    assert set(whole) >= {"residual"} and any(r.abs().max() > 0 for r in adamw.tree_leaves(whole["residual"]))
    kw = _trainer_cfg(tmp_path, "resumed", compress_grads=True, ckpt_every=1)

    def preempt_after_2(state, _metrics):
        if state["step"] == 2:
            first.preempt.trigger()

    first = Trainer(tcfg, shape, TrainerConfig(**kw), hooks={"on_step": preempt_after_2}, device="cpu")
    part1 = first.run()
    part2 = Trainer(tcfg, shape, TrainerConfig(**kw), device="cpu").run()
    assert part1["step"] == 2 and part2["step"] == 4
    assert part1["losses"] + part2["losses"] == whole["losses"]
    for a, b in zip(adamw.tree_leaves(part2["residual"]), adamw.tree_leaves(whole["residual"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_keeps_bf16_bits(tmp_path):
    """bf16 leaves go to disk as their bits and come back unchanged."""
    from repro_torch.checkpoint import CheckpointManager

    tree = {"w": torch.randn(3, 5).to(torch.bfloat16), "opt": adamw.AdamWState(
        step=torch.tensor(7, dtype=torch.int32), m={"w": torch.randn(3, 5)}, v={"w": None})}
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=1)
    mgr.save_async(1, tree)
    mgr.wait()
    back = mgr.restore(1, tree)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], tree["w"])
    assert int(back["opt"].step) == 7 and back["opt"].v["w"] is None
    assert np.load(tmp_path / "ck" / "step_0000000001" / "leaf_000002.npy").dtype == np.int16


def test_launcher_trains_and_refuses_unported_flags(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import train as launcher

    argv = ["train", "--arch", "olmo-1b", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    monkeypatch.setattr("sys.argv", argv)
    launcher.main()
    assert "done at step 2 on cpu" in capsys.readouterr().out
    # int8 projections and int8-compressed gradients train (a fresh
    # checkpoint directory: the state then holds the residual).
    monkeypatch.setattr("sys.argv", argv[:-1] + [str(tmp_path / "ck8"), "--quant", "int8", "--compress-grads"])
    launcher.main()
    assert "done at step 2 on cpu" in capsys.readouterr().out
    # --metrics-out and --trace-out are ported (tests/test_torch_obs.py).
    # The recurrent families, smoke configs.
    for arch in ("zamba2-1.2b", "xlstm-125m"):
        monkeypatch.setattr("sys.argv", ["train", "--arch", arch] + argv[3:-1] + [str(tmp_path / arch)])
        launcher.main()
        assert "done at step 2 on cpu" in capsys.readouterr().out
    # --mesh is ported: a 1 x 1 mesh trains in this process (a world-size-1
    # gloo group, destroyed at the end; the losses are the meshless run's:
    # tests/test_torch_dist.py), a larger one needs torchrun's ranks.
    monkeypatch.setattr("sys.argv", argv[:-1] + [str(tmp_path / "ck11"), "--mesh", "1x1"])
    launcher.main()
    assert "done at step 2 on cpu" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", argv + ["--mesh", "2x1"])
    with pytest.raises(SystemExit, match="runs under torchrun"):
        launcher.main()
