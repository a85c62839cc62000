"""The training half's parts on the CPU against the JAX package's, on the
same seeded numpy inputs: ``cross_entropy`` (padded-vocab mask, ignored
labels, z-loss), the warmup-cosine ``schedule``, ``global_norm``,
``apply_updates`` given identical gradients (float32 and bfloat16
moments), the int8 compression and its error feedback, the data
pipeline's tokens (bit for bit), ``dp_width``, ``schedule_to_plan`` and
``job_from_arch`` fed to each package's OASiS.

Tolerances: the loss, the schedule and the norm at relative 1e-6
(float32 arithmetic in another order); AdamW's parameters at relative
max-abs 1e-6 and its float32 moments at 1e-6, after three steps from the
same state with the same gradients (Adam's first step divides by
sqrt(v^) ~ |g|, so gradients are held on their own in
test_torch_train_models.py and given identically here); bfloat16 moments
within one bfloat16 ulp (a float32 difference of one ulp may round
either way); int8 codes equal and scales at 1e-7; tokens, plans and job
fields exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.core.oasis import OASiS as JaxOASiS
from repro.core.pricing import price_params_from_jobs as jax_price_params
from repro.core.types import job_from_arch as jax_job_from_arch
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.runtime.elastic import dp_width as jax_dp_width
from repro.runtime.elastic import schedule_to_plan as jax_schedule_to_plan
from repro.sim.workload import make_cluster as jax_make_cluster
from repro.train import compress as jax_compress
from repro.train import optimizer as jax_opt
from repro.train.steps import cross_entropy as jax_cross_entropy
from repro_torch.core.oasis import OASiS
from repro_torch.core.pricing import price_params_from_jobs
from repro_torch.core.types import H100_BF16_FLOPS, job_from_arch
from repro_torch.data.pipeline import (DataConfig, DataPipeline,
                                       PipelineState)
from repro_torch.models import convert
from repro_torch.models.layers import tree_leaves
from repro_torch.runtime.elastic import dp_width, schedule_to_plan
from repro_torch.sim.workload import make_cluster
from repro_torch.train import compress
from repro_torch.train import optimizer as opt
from repro_torch.train.steps import cross_entropy


def leaves(tree):
    return tree_leaves(tree, lambda x: isinstance(x, torch.Tensor))


def close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.mark.parametrize("vpad,vocab,z", [(40, 32, 0.0), (40, 32, 1e-4),
                                          (64, 64, 1e-4)])
def test_cross_entropy_matches_jax(vpad, vocab, z):
    rng = np.random.default_rng(vpad + vocab)
    logits = (rng.standard_normal((2, 8, vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 8))
    labels[1, :3] = -1                        # ignored
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             vocab, z)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        vocab, z)
    close(got, want, 1e-6)
    if z == 0.0:   # the reference test's naive form
        lp = torch.log_softmax(torch.where(torch.arange(vpad) >= vocab,
                                           -1e30, torch.from_numpy(logits)),
                               -1)
        keep = torch.from_numpy(labels) >= 0
        nll = -torch.gather(lp, -1, torch.from_numpy(labels).clamp(min=0)
                            [..., None])[..., 0]
        assert float(got) == pytest.approx(float(nll[keep].mean()), rel=1e-5)


def test_all_labels_ignored_gives_zero():
    logits = torch.zeros(1, 4, 8)
    assert float(cross_entropy(logits, torch.full((1, 4), -1), 8, 1e-4)) \
        == 0.0


def test_schedule_matches_jax():
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jax_opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        close(opt.schedule(cfg, step),
              jax_opt.schedule(jcfg, jnp.asarray(step)), 1e-6)
    assert float(opt.schedule(cfg, 0)) == pytest.approx(0.0)
    assert float(opt.schedule(cfg, 10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(opt.schedule(cfg, 100)) == pytest.approx(1e-4, rel=1e-3)


def _tree(rng):
    """A parameter tree with a stacked leaf, a list, a zero-gradient leaf
    and small gradients beside large ones."""
    return {"a": rng.standard_normal((3, 5, 4)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)],
            "c": rng.standard_normal(6).astype(np.float32)}


def _grads(rng, step):
    g = _tree(rng)
    g["b"][0] = g["b"][0] * 1e-4
    g["c"] = np.zeros(6, np.float32) if step == 0 else g["c"] * 3
    return g


def test_global_norm_matches_jax():
    t = _tree(np.random.default_rng(0))
    close(opt.global_norm(convert.params_from_numpy(t, "cpu")),
          jax_opt.global_norm(jax.tree_util.tree_map(jnp.asarray, t)), 1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [2.0, 1e3], ids=["clipped",
                                                       "unclipped"])
def test_apply_updates_matches_jax_given_the_same_gradients(moments,
                                                            clip_norm):
    """Three steps of the in-place AdamW against the reference's, fed the
    same gradients (global norm ~9: clipped at 2, not at 1e3)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm,
              moment_dtype=moments)
    cfg, jcfg = opt.OptConfig(**kw), jax_opt.OptConfig(**kw)
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jax_opt.init_opt(jp, jcfg)
    p = convert.params_from_numpy(p0, "cpu")
    s = opt.init_opt(p, cfg)
    for step in range(3):
        g = _grads(rng, step)
        jp, js, jm = jax_opt.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        p, s, m = opt.apply_updates(p, convert.params_from_numpy(g, "cpu"),
                                    s, cfg)
        close(m["grad_norm"], jm["grad_norm"], 1e-6)
        close(m["lr"], jm["lr"], 1e-6)
    assert int(s.step) == int(js.step) == 3
    for got, want in zip(leaves(p), jax.tree_util.tree_leaves(jp)):
        close(got, want, 1e-6)
    for tree, jtree in ((s.mu, js.mu), (s.nu, js.nu)):
        for got, want in zip(leaves(tree), jax.tree_util.tree_leaves(jtree)):
            assert got.dtype == getattr(torch, moments)
            want = np.asarray(want.astype(jnp.float32))
            if moments == "float32":
                close(got, want, 1e-6)
            else:   # within one bfloat16 ulp of each element
                got = got.float().numpy()
                assert np.all(np.abs(got - want)
                              <= 2.0 ** -7 * np.abs(want) + 1e-30)


def test_opt_state_carried_across():
    rng = np.random.default_rng(1)
    t = _tree(rng)
    js = jax_opt.OptState(jnp.asarray(4, jnp.int32),
                          jax.tree_util.tree_map(jnp.asarray, t),
                          jax.tree_util.tree_map(jnp.asarray, _tree(rng)))
    s = convert.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert isinstance(s, opt.OptState) and int(s.step) == 4
    assert s.step.dtype == torch.int32
    np.testing.assert_array_equal(s.mu["a"].numpy(), t["a"])


def test_int8_quantization_matches_jax():
    rng = np.random.default_rng(2)
    for x in (rng.standard_normal(300).astype(np.float32) * 5,
              np.zeros(4, np.float32),
              np.array([0.5, -1.5, 2.5, 127.0], np.float32)):
        q, s = compress.quantize_int8(torch.from_numpy(x))
        jq, js = jax_compress.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        close(s, js, 1e-7)
        close(compress.dequantize(q, s), jax_compress.dequantize(jq, js),
              1e-7)
    t = _tree(rng)
    got = compress.compress_grads(convert.params_from_numpy(t, "cpu"))
    want = jax_compress.compress_grads(jax.tree_util.tree_map(jnp.asarray,
                                                              t))
    for a, b in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        close(a, b, 1e-7)


def test_error_feedback_matches_jax_and_reduces_bias():
    rng = np.random.default_rng(0)
    g0 = {"g": rng.normal(size=(256,)).astype(np.float32)}
    res = compress.ErrorFeedback.init(convert.params_from_numpy(g0, "cpu"))
    jres = jax_compress.ErrorFeedback.init(
        jax.tree_util.tree_map(jnp.asarray, g0))
    acc_plain, acc_ef, acc_true = (np.zeros(256) for _ in range(3))
    for _ in range(50):
        gs = {"g": rng.normal(size=(256,)).astype(np.float32)}
        out, res = compress.ErrorFeedback.apply(
            convert.params_from_numpy(gs, "cpu"), res)
        jout, jres = jax_compress.ErrorFeedback.apply(
            jax.tree_util.tree_map(jnp.asarray, gs), jres)
        close(out["g"], jout["g"], 1e-6)
        close(res["g"], jres["g"], 1e-5)
        acc_plain += compress.dequantize(
            *compress.quantize_int8(torch.from_numpy(gs["g"]))).numpy()
        acc_ef += out["g"].numpy()
        acc_true += gs["g"]
    assert np.abs(acc_ef - acc_true).mean() < np.abs(acc_plain
                                                     - acc_true).mean()


def test_data_pipeline_tokens_bit_for_bit():
    kw = dict(vocab_size=257, seq_len=33, global_batch=4, seed=3,
              n_chunks=16)
    p, jp = DataPipeline(DataConfig(**kw)), JaxDataPipeline(
        JaxDataConfig(**kw))
    batches = []
    for _ in range(6):
        b, jb = p.next_batch(), jp.next_batch()
        for k in ("tokens", "labels"):
            assert b[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(b[k], jb[k])
        batches.append(b)
    assert p.state.to_dict() == jp.state.to_dict() == {"step": 6}
    resumed = DataPipeline(DataConfig(**kw),
                           PipelineState.from_dict({"step": 2}))
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  batches[2]["tokens"])
    halves = [p.worker_slice(batches[0], w, 2)["tokens"] for w in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves),
                                  batches[0]["tokens"])


@pytest.mark.parametrize("workers,devices", [(5, 8), (16, 8), (1, 8),
                                             (0, 4), (8, 1), (7, 7)])
def test_dp_width_matches_jax(workers, devices):
    assert dp_width(workers, devices) == jax_dp_width(workers, devices)


def test_job_from_arch_fed_to_oasis_matches_jax():
    """The reference's test_job_from_arch_closes_the_loop on both
    packages with both chip figures passed (the port's defaults are an
    H100's): the same job fields, and each package's OASiS admits it with
    the same schedule, turned into the same slot plan."""
    kw = dict(flops_per_token=6 * 3e9, param_bytes=12e9,
              tokens_per_step=2 ** 19, target_steps=1000,
              chip_flops=197e12, chip_bw=50e9)
    job = job_from_arch("starcoder2-3b", 0, **kw)
    jjob = jax_job_from_arch("starcoder2-3b", 0, **kw)
    for f in ("arrival", "epochs", "num_chunks", "minibatches_per_chunk",
              "tau", "grad_size", "worker_bw", "ps_bw", "quantum"):
        assert getattr(job, f) == getattr(jjob, f), f
    np.testing.assert_array_equal(job.worker_res, jjob.worker_res)
    np.testing.assert_array_equal(job.ps_res, jjob.ps_res)
    assert job.utility(7.0) == jjob.utility(7.0)
    cluster, jcluster = (make_cluster(T=50, H=10, K=10),
                         jax_make_cluster(T=50, H=10, K=10))
    s = OASiS(cluster, price_params_from_jobs([job], cluster),
              device="cpu").on_arrival(job)
    js = JaxOASiS(jcluster, jax_price_params([jjob], jcluster)
                  ).on_arrival(jjob)
    assert s is not None and js is not None and s.utility > 0
    assert (s.finish, s.utility) == (js.finish, js.utility)
    assert [(p.slot, p.n_workers) for p in schedule_to_plan(s)] == \
        [(p.slot, p.n_workers) for p in jax_schedule_to_plan(js)]
    h100 = job_from_arch("starcoder2-3b", 0, flops_per_token=6 * 3e9,
                         param_bytes=12e9, tokens_per_step=2 ** 19,
                         target_steps=1000)
    assert h100.tau == pytest.approx(job.tau * 197e12 / H100_BF16_FLOPS)
