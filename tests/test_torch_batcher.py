"""The port's continuous batcher (``serve/batcher.py``) and its per-row
decode (``decode_step`` with a (B,) ``cache_len``) against the JAX
package's, on the CPU, at smoke size in float32.

* ``tests/test_batcher.py``'s two tests on the port: every request's
  output equals the same request decoded alone, and rows are reused
  (later requests start only after a row frees, fewer steps than the
  serial sum);
* each request's tokens, start and finish steps under the port's batcher
  equal the reference batcher's, on the same seeded weights (carried
  across by ``models/convert.py``) and requests;
* one ``decode_step`` with an unequal (B,) ``cache_len`` over a seeded
  random cache equals the reference's, logits and every cache leaf at
  relative 1e-4, on every family with an attention cache: starcoder2,
  gemma2_9b (its local cache rolled in one row), olmoe (at
  ``capacity_factor = n_experts``, so that the decode's capacity drops
  nothing), deepseek_v3 (MLA's latent cache) and zamba2 (the shared
  attention block's cache; its SSM state is per row already);
* Whisper with a (B,) ``cache_len`` raises in the port, as the
  reference's decode fails there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense as dense
from _torch_parity import one_torch_thread  # noqa: F401
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.batcher import Request as JaxRequest
from repro_torch.models import convert
from repro_torch.models.model import decode_step, init_cache, init_model
from repro_torch.serve.batcher import ContinuousBatcher, Request
from repro_torch.configs import get_smoke

MAX_LEN = 48
rel = dense.rel


def _port_setup(arch="starcoder2_3b", batch=3, seed=7):
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32")
    params = init_model(cfg, seed=seed, device="cpu")
    cache = init_cache(cfg, batch, MAX_LEN, dtype=torch.float32,
                       device="cpu")
    return cfg, params, _step(params, cfg), cache


def _step(params, cfg):
    def step(t, c, n):
        with torch.inference_mode():
            return decode_step(params, cfg, t, c, n)
    return step


def _solo_decode(cfg, params, prompt, max_new, max_len=MAX_LEN):
    """One request alone through ``decode_step`` with an int cache_len,
    the reference test's loop."""
    cache = init_cache(cfg, 1, max_len, dtype=torch.float32, device="cpu")
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)[None, :]
    out, cur = [], None
    with torch.inference_mode():
        for i in range(len(prompt) + max_new - 1):
            t = toks[:, i:i + 1] if i < len(prompt) else cur
            lg, cache = decode_step(params, cfg, t, cache, i)
            if i >= len(prompt) - 1:
                cur = torch.argmax(lg[:, :, :cfg.vocab_size], -1)
                out.append(int(cur[0, 0]))
                if len(out) >= max_new:
                    break
    return out


def test_batcher_matches_solo_decoding():
    cfg, params, step, cache = _port_setup()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=pl),
                    max_new=4) for i, pl in enumerate([5, 3, 7, 4, 6])]
    bat = ContinuousBatcher(batch=3, max_len=MAX_LEN, decode_fn=step,
                            device="cpu")
    for r in reqs:
        bat.submit(r)
    bat.run(cache)
    assert len(bat.done) == len(reqs)
    for r in reqs:
        solo = _solo_decode(cfg, params, r.prompt, r.max_new)
        assert r.output == solo, (r.rid, r.output, solo)


def test_batcher_overlaps_requests():
    """More requests than rows: later requests start only after a row
    frees; total steps < sum of independent lengths (actual batching)."""
    cfg, params, step, cache = _port_setup(batch=2)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=4),
                    max_new=3) for i in range(4)]
    bat = ContinuousBatcher(batch=2, max_len=MAX_LEN, decode_fn=step,
                            device="cpu")
    for r in reqs:
        bat.submit(r)
    bat.run(cache)
    assert len(bat.done) == 4
    serial_steps = sum(len(r.prompt) + r.max_new for r in reqs)
    assert bat.step_no < serial_steps
    starts = sorted(r.started_step for r in reqs)
    assert starts[2] > starts[0]


def test_batcher_matches_reference_batcher():
    """Seven requests of unequal prompts and lengths over three rows, an
    end-of-sequence id in play: the port's batcher and the reference's
    on the same weights give the same tokens, start and finish steps,
    request by request, in the same number of steps."""
    jcfg, cfg, jparams, params = dense.make_smoke("starcoder2_3b")
    batch = 3
    rng = np.random.default_rng(5)
    specs = [(int(rng.integers(2, 9)), int(rng.integers(2, 7)))
             for _ in range(7)]
    prompts = [rng.integers(0, cfg.vocab_size, size=pl) for pl, _ in specs]
    jstep = jax.jit(lambda t, c, n: jax_decode_step(jparams, jcfg, t, c, n))
    runs = []
    for Batcher, Req, step, cache in (
            (JaxBatcher, JaxRequest, jstep,
             jax_init_cache(jcfg, batch, MAX_LEN, dtype=jnp.float32)),
            (ContinuousBatcher, Request, _step(params, cfg),
             init_cache(cfg, batch, MAX_LEN, dtype=torch.float32,
                        device="cpu"))):
        kw = {"device": "cpu"} if Batcher is ContinuousBatcher else {}
        bat = Batcher(batch=batch, max_len=MAX_LEN, decode_fn=step,
                      eos_id=17, **kw)
        reqs = [Req(rid=i, prompt=p, max_new=mn)
                for i, (p, (_, mn)) in enumerate(zip(prompts, specs))]
        for r in reqs:
            bat.submit(r)
        bat.run(cache)
        runs.append((bat.step_no, [(r.output, r.started_step,
                                    r.finished_step) for r in reqs]))
    assert runs[0] == runs[1]
    assert len(runs[1][1]) == 7


PER_ROW = [("starcoder2_3b", {}, [3, 29]),
           ("gemma2_9b", {}, [5, 40]),            # 40 % 32: a rolled row
           ("olmoe_1b_7b", {"capacity_factor": 8.0}, [0, 17]),
           ("deepseek_v3_671b", {}, [11, 2]),
           ("zamba2_7b", {}, [7, 30])]


def _random_cache(jcfg, batch, max_len, seed):
    """A JAX decode cache of ``max_len`` filled with seeded numbers (every
    slot, past each row's length too: the mask must hide them)."""
    rng = np.random.default_rng(seed)
    cache = jax_init_cache(jcfg, batch, max_len, dtype=jnp.float32)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(
            np.float32)), cache)


@pytest.mark.parametrize("arch,changes,lengths", PER_ROW,
                         ids=[a for a, _, _ in PER_ROW])
def test_per_row_decode_step_matches_jax(arch, changes, lengths):
    jcfg, cfg, jparams, params = dense.make_smoke(arch, **changes)
    batch = len(lengths)
    jcache = _random_cache(jcfg, batch, MAX_LEN, seed=len(arch))
    pcache = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    tok = dense.tokens(cfg, 1, seed=3, batch=batch)
    n = np.asarray(lengths)
    want, jcache = jax_decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                   jnp.asarray(n, jnp.int32))
    with torch.inference_mode():
        got, pcache = decode_step(params, cfg, torch.from_numpy(tok), pcache,
                                  torch.from_numpy(n))
    assert rel(got, want) < 1e-4
    for path, p, r in _pairs(pcache, jcache):
        assert rel(p, r) < 1e-4, path


def _pairs(port, ref, path=""):
    """``dense.pairs`` through lists too (Zamba2's period of SSM layers)."""
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _pairs(p, r, f"{path}/{i}")
    elif isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    else:
        yield path, port, ref


def test_encdec_vector_cache_len_raises_as_in_jax():
    """Whisper with a (B,) cache_len: the reference's decode fails
    (``pos_tab[positions][None]`` makes a 4-D hidden state); the port
    refuses the same call with NotImplementedError, and still decodes an
    int cache_len."""
    jcfg, cfg, jparams, params = dense.make_smoke("whisper_large_v3")
    tok = dense.tokens(cfg, 1, seed=4)
    jcache = jax_init_cache(jcfg, 2, 8, dtype=jnp.float32)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                        jnp.asarray([0, 3], jnp.int32))
    pcache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="model.py:382"):
        decode_step(params, cfg, torch.from_numpy(tok), pcache,
                    torch.tensor([0, 3]))
    want, _ = jax_decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                              jnp.int32(3))
    with torch.inference_mode():
        got, _ = decode_step(params, cfg, torch.from_numpy(tok), pcache, 3)
    assert rel(got, want) < 1e-4
