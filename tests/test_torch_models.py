"""The port's model stack and serving path against the JAX package's, on
the CPU, at smoke size.

The JAX package's own initialised parameters are carried across as numpy
arrays (``models/convert.py::params_from_numpy``), and the same seeded
tokens go through both:

* ``prefill`` of the Zamba2 and Mamba2 smoke configs (float32) at B = 2,
  S = 300, so that S * S > 256 * 256 takes the chunked attention branch
  and the SSD runs 19 chunks with a ragged last one: the last logits and
  every cache leaf at relative max-abs 1e-4;
* 8 ``decode_step``s from that prefill, on both sides through the same
  cache glue, at the same tolerance;
* the port's serving route (prefill, then greedy decode) against the
  JAX launcher's teacher-forced route (``launch/serve.py``: the prompt
  one token at a time through ``decode_step``), at relative 2e-2 (the
  JAX package's bound for decode against a full forward,
  ``tests/test_models.py::test_decode_matches_train_forward``) and with
  the same greedy tokens.

The dense family's parity runs in ``test_torch_dense.py`` and
``test_torch_gemma2.py``, the MoE family's in ``test_torch_moe.py`` and
``test_torch_mla.py``; here their parameter trees are carried across
too, every config's full-width shapes equal the JAX package's leaf by
leaf, every config of the registry is served (Whisper's enc-dec family
since its slice, ``test_torch_whisper.py``), and a family the port does
not know is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models.layers import param_count as jax_param_count
from repro.models.layers import shapes_tree as jax_shapes_tree
from repro.models.model import model_specs as jax_model_specs
from repro.models.model import prefill as jax_prefill
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as serve_launch
from repro_torch.models import ModelConfig, convert
from repro_torch.models.layers import param_count, shapes_tree
from repro_torch.models.model import (SERVED_FAMILIES, decode_step,
                                      init_cache, init_model, model_specs,
                                      prefill)
from repro_torch.serve import steps

ARCHS = ["zamba2_7b", "mamba2_370m"]
B, S, STEPS = 2, 300, 8


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / (
        float(np.max(np.abs(want))) + 1e-9)


def _pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) over two trees of one nesting."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)) and not (
            ref and isinstance(ref[0], int)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _pairs(p, r, f"{path}[{i}]")
    else:
        yield path, port, ref


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, JAX config, port config, JAX params, port params), float32."""
    arch = request.param
    jcfg = jax_get_smoke(arch).scaled(dtype="float32",
                                      param_dtype="float32")
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32")
    jparams = jax_init_model(jax.random.PRNGKey(1), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return arch, jcfg, cfg, jparams, params


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _jax_decode_cache(jcfg, pcache, max_len):
    """The serving glue on the JAX side: the prefill cache written into
    ``init_cache(..., float32)`` (attention K/V at positions [0, S))."""
    cache = jax_init_cache(jcfg, B, max_len, dtype=jnp.float32)

    def put(dst, src, key=None):
        if isinstance(dst, dict):
            return {k: put(dst[k], src[k], k) for k in dst}
        if isinstance(dst, list):
            return [put(d, s, key) for d, s in zip(dst, src)]
        if key in ("k", "v"):
            return dst.at[:, :, :src.shape[2]].set(src)
        return src.astype(dst.dtype)
    return put(cache, pcache)


@pytest.mark.parametrize("smoke", ARCHS + ["starcoder2_3b", "gemma2_9b",
                                   "olmoe_1b_7b", "deepseek_v3_671b"],
                         indirect=True)
def test_params_carried_across_keep_the_tree(smoke):
    _, jcfg, cfg, jparams, params = smoke
    for path, p, r in _pairs(params, jparams):
        assert isinstance(p, torch.Tensor) and p.dtype == torch.float32, path
        assert np.array_equal(p.numpy(), np.asarray(r)), path
    specs = jax_shapes_tree(jax_model_specs(jcfg))
    for path, p, r in _pairs(shapes_tree(model_specs(cfg)), specs):
        assert tuple(p) == tuple(r), path
    assert param_count(params) == jax_param_count(jparams)


def test_prefill_and_decode_match_jax(smoke):
    """Prefill logits and every cache leaf, then 8 decode steps (logits
    each step, every cache leaf after the last), relative 1e-4."""
    arch, jcfg, cfg, jparams, params = smoke
    toks = _tokens(cfg, S + STEPS, seed=11)
    want_logits, want_cache = jax_prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S])}, S)
    with torch.inference_mode():
        logits, cache = prefill(params, cfg,
                                {"tokens": torch.from_numpy(toks[:, :S])}, S)
    assert logits.shape == want_logits.shape
    assert _rel(logits, want_logits) < 1e-4
    leaves = list(_pairs(cache, want_cache))
    # Zamba2 smoke: 2 periods of 2 SSM layers (3 leaves each) and the
    # shared block's K/V, then a 1-layer tail; Mamba2: one SSM group
    assert len(leaves) == (2 * 3 + 2 + 3 if arch == "zamba2_7b" else 3)
    for path, p, r in leaves:
        assert _rel(p, r) < 1e-4, path

    max_len = S + STEPS
    jcache = _jax_decode_cache(jcfg, want_cache, max_len)
    _, pcache = steps.prefill_into_cache(
        params, cfg, torch.from_numpy(toks[:, :S]), max_len)
    jstep = jax.jit(lambda p, t, c, n: jax_decode_step(p, jcfg, t, c, n))
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        want, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                             jnp.int32(S + i))
        with torch.inference_mode():
            got, pcache = decode_step(params, cfg, torch.from_numpy(tok),
                                      pcache, S + i)
        assert _rel(got, want) < 1e-4, i
    for path, p, r in _pairs(pcache, jcache):
        assert _rel(p, r) < 1e-4, path


def test_serve_prefill_route_matches_jax_teacher_forced(smoke):
    """The port's serving route against ``repro/launch/serve.py``'s: the
    JAX launcher feeds the prompt through ``decode_step`` one token at a
    time into its default (bfloat16) cache, then decodes greedily."""
    _, jcfg, cfg, jparams, params = smoke
    prompt, gen = 40, 6
    toks = _tokens(cfg, prompt, seed=12)
    jstep = jax.jit(lambda p, t, c, n: jax_decode_step(p, jcfg, t, c, n))
    jcache = jax_init_cache(jcfg, B, prompt + gen)
    for i in range(prompt):
        lg, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.int32(i))
    want_logits, want_toks = [lg], [jnp.argmax(lg[:, :, :jcfg.vocab_size], -1)]
    for i in range(gen - 1):
        lg, jcache = jstep(jparams, want_toks[-1], jcache,
                           jnp.int32(prompt + i))
        want_logits.append(lg)
        want_toks.append(jnp.argmax(lg[:, :, :jcfg.vocab_size], -1))
    out, logits = steps.generate(params, cfg, torch.from_numpy(toks), gen)
    assert np.array_equal(out.numpy(), np.concatenate(
        [np.asarray(t) for t in want_toks], 1))
    assert _rel(logits, jnp.concatenate(want_logits, 1)) < 2e-2


@pytest.mark.parametrize("arch,count", [("zamba2_7b", 6_662_132_944),
                                        ("mamba2_370m", None),
                                        ("granite_34b", 33_660_377_088),
                                        ("starcoder2_3b", 3_029_710_848),
                                        ("pixtral_12b", 12_247_782_400),
                                        ("gemma2_9b", 9_241_705_984),
                                        ("gemma2_27b", 27_227_128_320),
                                        ("olmoe_1b_7b", 6_816_339_968),
                                        ("deepseek_v3_671b",
                                         671_712_662_528),
                                        ("whisper_large_v3",
                                         1_534_937_600)])
def test_full_config_shapes_equal_jax(arch, count):
    """Full-width parameter shapes, leaf by leaf, without allocating."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mine = shapes_tree(model_specs(cfg))
    pairs = list(_pairs(mine, jax_shapes_tree(jax_model_specs(jcfg))))
    for path, p, r in pairs:
        assert tuple(p) == tuple(r), path
    total = sum(int(np.prod(p)) for _, p, _ in pairs)
    assert total == (count or sum(int(np.prod(r)) for _, _, r in pairs))


def test_launcher_serves_on_the_cpu():
    res = serve_launch.main(["--arch", "zamba2_7b", "--smoke", "--batch",
                             "2", "--prompt-len", "20", "--gen", "3",
                             "--warmup", "0", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["logits"]).all()
    assert res["prefill_launches"] == {"ssd": 0, "flash": 0}
    assert len(res["decode_ms"]) == 2 and res["device"] == "cpu"


def test_entry_points_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("zamba2_7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launch.main(["--arch", "zamba2_7b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy({"w": np.zeros(2)})


def test_unserved_families_raise():
    """Every config of the registry is served, the reference's registry
    all of it (Whisper's enc-dec family included); a family the port
    does not know is refused by the model stack and by the serving step,
    and a name outside the registry by ``get_config``."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        cfg = get_smoke(arch)
        assert cfg.family in SERVED_FAMILIES
        model_specs(cfg)
        init_cache(cfg, 1, 8, device="cpu")
    encdec = ModelConfig(**dataclasses.asdict(
        jax_get_smoke("whisper_large_v3")))
    assert encdec.family == "encdec"
    assert shapes_tree(model_specs(encdec)) == shapes_tree(
        model_specs(get_smoke("whisper_large_v3")))
    model_specs(get_smoke("starcoder2_3b").scaled(qk_norm=True))
    unknown = get_smoke("starcoder2_3b").scaled(family="retrieval")
    with pytest.raises(NotImplementedError, match="serves"):
        model_specs(unknown)
    with pytest.raises(NotImplementedError, match="serves"):
        steps.prefill_into_cache({}, unknown, torch.zeros((1, 4), dtype=int),
                                 8)
    with pytest.raises(NotImplementedError, match="serves"):
        get_config("whisper_tiny")
