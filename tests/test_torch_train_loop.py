"""Training loops of the port on the CPU: the reference's
``tests/test_train.py`` and the driver cases of ``tests/test_runtime.py``
on the port, and its train step against the JAX package's.

* ``TINY`` (2 layers, d 64, float32) trains on the seeded stream and its
  CE falls (last 5 steps under 0.8 x the first 5; with int8 gradient
  compression under 0.85 x), the reference test's bars;
* ``grad_accum`` k = 1, 2 and 4 give the same step (CE at relative 1e-6,
  parameters within 1e-5, the reference test's bar), and k = 1 and 4
  equal the JAX package's ``make_train_step`` at the same k (under the
  parity harness's ``jax.make_mesh`` shim) within the same bars;
* the launcher's first four steps (its ``OptConfig``, the StarCoder2
  smoke config in float32, batches from the stream) equal the JAX
  package's ``value_and_grad(loss_fn)`` and ``apply_updates`` at every
  step: CE and gradient norm at relative 1e-5, each parameter leaf at
  relative max-abs 1e-5 (steps 2-4 through the in-place AdamW);
* ``run_with_restarts`` with injected faults reaches the uninterrupted
  run's state (the reference's numpy case; a TINY train step whose
  restored run equals the uninterrupted one bit for bit);
* ``ElasticTrainer`` on the plan [4, 8, 2]: 30 steps at the widths
  ``dp_width`` gives on this host, CE falling, the last checkpoint
  restoring parameters, optimizer state and cursor;
* the launcher, ``--smoke --device cpu``, plain and ``--elastic``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as tt
from _torch_parity import jax_shims, one_torch_thread  # noqa: F401
from repro.models import init_model as jax_init_model
from repro.models.config import ModelConfig as JaxModelConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import apply_updates as jax_apply_updates
from repro.train.optimizer import init_opt as jax_init_opt
from repro.train.steps import TrainHyper as JaxHyper
from repro.train.steps import loss_fn as jax_loss_fn
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import init_model
from repro_torch.runtime.driver import FaultInjector, run_with_restarts
from repro_torch.runtime.elastic import ElasticTrainer, SlotPlan
from repro_torch.train.optimizer import OptConfig, init_opt
from repro_torch.train.steps import TrainHyper, make_train_step

TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=256, dtype="float32", param_dtype="float32",
               remat=False)
TINY = ModelConfig(**TINY_KW)
DATA = DataConfig(vocab_size=256, seq_len=32, global_batch=8, seed=0,
                  n_chunks=64)
LOOP_OPT = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                     weight_decay=0.0)


def leaves(tree):
    return tree_leaves(tree, lambda x: isinstance(x, torch.Tensor))


def clone(tree):
    return tree_map(lambda x: x.clone(), tree,
                    lambda x: isinstance(x, torch.Tensor))


def _losses(hyper, steps=40):
    pipe = DataPipeline(DATA)
    params = init_model(TINY, seed=0, device="cpu")
    opt = init_opt(params, LOOP_OPT)
    step = make_train_step(TINY, LOOP_OPT, hyper, device="cpu")
    out = []
    for _ in range(steps):
        params, opt, m = step(params, opt, pipe.next_batch())
        out.append(float(m["ce"]))
    return out


@pytest.mark.parametrize("compress,bar", [(False, 0.8), (True, 0.85)])
def test_tiny_loss_decreases(compress, bar):
    ce = _losses(TrainHyper(grad_compress=compress))
    assert np.all(np.isfinite(ce))
    assert np.mean(ce[-5:]) < np.mean(ce[:5]) * bar, (ce[:5], ce[-5:])


def test_grad_accum_matches_single_step_and_jax(jax_shims):  # noqa: F811
    jcfg = JaxModelConfig(**TINY_KW)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jopt = jax_init_opt(jparams, JaxOptConfig(lr=1e-3))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (8, 32)),
             "labels": rng.integers(0, 256, (8, 32))}
    jbatch = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = None
    for k in (1, 2, 4):
        params = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        opt = convert.opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt), "cpu")
        step = make_train_step(TINY, OptConfig(lr=1e-3),
                               TrainHyper(grad_accum=k), device="cpu")
        p2, o2, m = step(params, opt, batch)
        assert int(o2.step) == 1
        if k != 2:
            fn, _, _ = jax_make_train_step(jcfg, mesh, JaxOptConfig(lr=1e-3),
                                           JaxHyper(grad_accum=k))
            jp2, _, jm = jax.jit(fn)(jparams, jopt, jbatch)
            assert float(m["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-6)
            for got, want in zip(leaves(p2), jax.tree_util.tree_leaves(jp2)):
                assert float(np.max(np.abs(got.numpy()
                                           - np.asarray(want)))) < 1e-5
        if ref is None:
            ref = (leaves(p2), float(m["ce"]))
        else:
            assert float(m["ce"]) == pytest.approx(ref[1], rel=1e-6)
            for got, want in zip(leaves(p2), ref[0]):
                assert float((got - want).abs().max()) < 1e-5


def test_launcher_steps_match_jax_step_by_step():
    """Four steps under the launcher's ``OptConfig`` (lr 1e-3, warmup 10,
    total 4: lr 1e-4 x step), each package's own stream: the port's
    in-place step against the reference's functional one, every step."""
    jcfg, cfg, jp, params = tt.make_smoke("starcoder2_3b")
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=4)
    jopt_cfg = JaxOptConfig(**kw)
    jo, opt = jax_init_opt(jp, jopt_cfg), init_opt(params, OptConfig(**kw))

    @jax.jit
    def jax_step(jp, jo, batch):
        (_, m), g = jax.value_and_grad(jax_loss_fn, has_aux=True)(
            jp, jcfg, batch, JaxHyper())
        jp, jo, om = jax_apply_updates(jp, g, jo, jopt_cfg)
        return jp, jo, m["ce"], om["grad_norm"]

    step = make_train_step(cfg, OptConfig(**kw), TrainHyper(), device="cpu")
    data = dict(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    pipe, jpipe = (DataPipeline(DataConfig(**data)),
                   JaxDataPipeline(JaxDataConfig(**data)))
    for _ in range(4):
        batch, jbatch = pipe.next_batch(), jpipe.next_batch()
        jp, jo, jce, jnorm = jax_step(
            jp, jo, {k: jnp.asarray(v) for k, v in jbatch.items()})
        params, opt, m = step(params, opt, batch)
        assert float(m["ce"]) == pytest.approx(float(jce), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jnorm),
                                                      rel=1e-5)
        for got, want in zip(leaves(params), jax.tree_util.tree_leaves(jp)):
            want = np.asarray(want)
            assert (np.max(np.abs(got.numpy() - want))
                    <= 1e-5 * np.max(np.abs(want)))


def test_restart_on_injected_failures_numpy_state(tmp_path):
    """The reference's test_restart_on_injected_failures on the port."""
    cfg = DataConfig(vocab_size=31, seq_len=8, global_batch=2, seed=1)
    pipeline = DataPipeline(cfg)
    state = {"w": np.zeros(4, np.float32),
             "step_sum": np.zeros(1, np.float32)}

    def train_fn(state, batch, step):
        state = dict(state)
        state["w"] = state["w"] + 0.1
        state["step_sum"] = state["step_sum"] + batch["tokens"].mean()
        return state, float(np.abs(state["w"]).mean())

    out = run_with_restarts(train_fn, state, pipeline, str(tmp_path),
                            total_steps=50, save_every=10,
                            injector=FaultInjector(fail_at=[15, 37]))
    assert out["final_step"] == 50 and out["restarts"] == 2
    ref_pipeline = DataPipeline(cfg)
    ref = {"w": np.zeros(4, np.float32), "step_sum": np.zeros(1, np.float32)}
    for s in range(50):
        ref, _ = train_fn(ref, ref_pipeline.next_batch(), s)
    np.testing.assert_allclose(out["state"]["w"], ref["w"], rtol=1e-6)


def test_restart_resumes_a_train_step_bit_for_bit(tmp_path):
    """A TINY train step, which writes its state in place, under the
    driver: faults at steps 1 and 7 (one before the first periodic
    checkpoint: a cold restart from the driver's step-0 copy),
    checkpoints every 2 steps.  The restored run's parameters and
    optimizer state equal the uninterrupted run's bit for bit (one CPU
    thread, the same batches)."""
    step = make_train_step(TINY, LOOP_OPT, TrainHyper(), device="cpu")
    params = init_model(TINY, seed=0, device="cpu")
    init = {"params": params, "opt": init_opt(params, LOOP_OPT)}

    def train_fn(state, batch, i):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, float(m["ce"])

    def run(directory, injector):
        return run_with_restarts(train_fn, clone(init), DataPipeline(DATA),
                                 str(directory), total_steps=10,
                                 save_every=2, injector=injector)
    got = run(tmp_path / "faulty", FaultInjector(fail_at=[1, 7]))
    want = run(tmp_path / "clean", None)
    assert got["restarts"] == 2 and got["final_step"] == 10
    for a, b in zip(leaves(got["state"]), leaves(want["state"])):
        assert torch.equal(a, b)


def test_elastic_trainer_follows_the_plan(tmp_path):
    """The reference's test_elastic_trainer_changes_width on the port."""
    widths = []

    def make_step(width):
        widths.append(width)
        return make_train_step(TINY, OptConfig(lr=3e-3, warmup_steps=5,
                                               total_steps=100,
                                               weight_decay=0.0),
                               device="cpu")

    params = init_model(TINY, seed=0, device="cpu")
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=100,
                        weight_decay=0.0)
    trainer = ElasticTrainer(TINY, opt_cfg, DATA, str(tmp_path), make_step,
                             steps_per_slot=10)
    out = trainer.run([SlotPlan(0, 4), SlotPlan(1, 8), SlotPlan(2, 2)],
                      params, init_opt(params, opt_cfg))
    assert out["steps"] == 30
    ces = [m["ce"] for m in trainer.metrics_log]
    assert np.mean(ces[-5:]) < np.mean(ces[:5])
    n_dev = torch.cuda.device_count() or 1
    assert trainer.mesh_history == widths == [min(4, n_dev), min(8, n_dev),
                                              min(2, n_dev)]
    assert ckpt.latest_step(str(tmp_path)) == 30
    state, extra = ckpt.restore(str(tmp_path), 30,
                                {"params": out["params"], "opt": out["opt"]})
    assert extra == {"pipeline": {"step": 30}, "slot": 2}
    assert int(state["opt"].step) == 30
    for a, b in zip(leaves(state), leaves({"params": out["params"],
                                           "opt": out["opt"]})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [[], ["--elastic", "--compress-grads"]])
def test_launcher_smoke_on_cpu(tmp_path, capsys, extra):
    launch_train.main(["--arch", "starcoder2_3b", "--smoke", "--steps", "3",
                       "--seq", "16", "--batch", "2", "--device", "cpu",
                       "--ckpt", str(tmp_path)] + extra)
    out = capsys.readouterr().out
    assert "done: 3 steps" in out
    if extra:
        assert "OASiS plan" in out and "dp widths" in out
