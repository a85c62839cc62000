"""The port's checkpoints (``repro_torch/ckpt/checkpoint.py``) against the
reference's format (``repro/ckpt/checkpoint.py``): a round trip of a
nested tree, corruption detected by the crc32, ``keep_last`` retention,
the async writer, and a policy checkpoint written by either package
loading in the other with equal logits."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.rl import policy as ref_pol
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models.layers import tree_leaves
from repro_torch.rl import policy as pol
from repro_torch.rl.env import OBS_DIM

from _torch_parity import one_torch_thread  # noqa: F401


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"b": {"w": torch.randn(3, 4, generator=g),
                  "n": torch.arange(5, dtype=torch.int64)},
            "a": [torch.randn(2, generator=g, dtype=torch.float64),
                  {"z": torch.ones(1, dtype=torch.float16)}],
            "h": np.arange(6, dtype=np.int32).reshape(2, 3)}


def _leaves(tree):
    return tree_leaves(tree, lambda x: isinstance(x, (torch.Tensor,
                                                      np.ndarray)))


def test_round_trip_and_layout(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 3, tree, extra={"k": [1, 2]})
    assert path.name == "ckpt_3" and ckpt.latest_step(str(tmp_path)) == 3
    manifest = json.loads((path / "manifest.json").read_text())
    assert sorted(manifest["leaves"]) == ["a/0", "a/1/z", "b/n", "b/w", "h"]
    assert manifest["leaves"]["b/w"] == {
        "shape": [3, 4], "dtype": "float32",
        "crc32": manifest["leaves"]["b/w"]["crc32"]}
    target = {"b": {"w": torch.zeros(3, 4), "n": torch.zeros(5,
                                                             dtype=torch.int64)},
              "a": [torch.zeros(2, dtype=torch.float64),
                    {"z": torch.zeros(1, dtype=torch.float16)}],
              "h": np.zeros((2, 3), np.int32)}
    out, extra = ckpt.restore(str(tmp_path), 3, target)
    assert extra == {"k": [1, 2]}
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert np.array_equal(a, b)
    assert not list(tmp_path.glob(".tmp_*"))


def test_restore_places_on_the_targets_device_and_dtype(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.arange(4, dtype=torch.float32)})
    out, _ = ckpt.restore(str(tmp_path), 0,
                          {"w": torch.zeros(4, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    # a target on another device (here the shape-only "meta" device)
    out, _ = ckpt.restore(str(tmp_path), 0,
                          {"w": torch.empty(4, device="meta")})
    assert out["w"].device.type == "meta" and out["w"].shape == (4,)


def test_corruption_detected(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    path = ckpt.save(str(tmp_path), 1, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["leaves"]["w"]["crc32"] ^= 1
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), 1, tree)
    out, _ = ckpt.restore(str(tmp_path), 1, tree, verify=False)
    assert torch.equal(out["w"], tree["w"])


def test_retention_keeps_the_last(tmp_path):
    for step in (1, 5, 2, 9, 7):
        ckpt.save(str(tmp_path), step, {"w": torch.full((2,), float(step))},
                  keep_last=2)
    assert sorted(p.name for p in tmp_path.glob("ckpt_*")) == ["ckpt_7",
                                                               "ckpt_9"]
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_snapshots_at_the_call(tmp_path):
    w = torch.zeros(4)
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep_last=5)
    saver.save_async(1, {"w": w}, extra={"t": True})
    w += 1.0                                   # after the call: not saved
    saver.save_async(2, {"w": w})
    saver.wait()
    one, extra = ckpt.restore(str(tmp_path), 1, {"w": torch.empty(4)})
    two, _ = ckpt.restore(str(tmp_path), 2, {"w": torch.empty(4)})
    assert one["w"].tolist() == [0.0] * 4 and two["w"].tolist() == [1.0] * 4
    assert extra == {"t": True}
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "f" / "x"))
    (tmp_path / "f").write_text("a file, not a directory")
    bad.save_async(3, {"w": w})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                                 # the error is raised once


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    rcfg = ref_pol.PolicyConfig(d_model=32)
    rp = ref_pol.policy_init(jax.random.PRNGKey(4), rcfg)
    ref_pol.save_policy(str(tmp_path), rp, rcfg, step=2, extra={"n": 1})
    params, cfg, extra = pol.load_policy(str(tmp_path), device="cpu")
    assert cfg == pol.PolicyConfig(d_model=32) and extra["n"] == 1
    obs = np.random.default_rng(0).random(OBS_DIM).astype(np.float32)
    lw, ls = pol.policy_logits(params, torch.from_numpy(obs), cfg)
    rlw, rls = ref_pol.policy_logits(rp, jnp.asarray(obs), rcfg)
    np.testing.assert_allclose(lw.numpy(), np.asarray(rlw), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ls.numpy(), np.asarray(rls), rtol=1e-5,
                               atol=1e-7)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    cfg = pol.PolicyConfig(d_model=32)
    params = pol.policy_init(torch.Generator().manual_seed(4), cfg)
    pol.save_policy(str(tmp_path), params, cfg, step=3)
    rp, rcfg, _ = ref_pol.load_policy(str(tmp_path))
    assert rcfg == ref_pol.PolicyConfig(d_model=32)
    for a, b in zip(tree_leaves(params, lambda x: isinstance(x,
                                                             torch.Tensor)),
                    jax.tree_util.tree_leaves(rp)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    obs = np.random.default_rng(1).random(OBS_DIM).astype(np.float32)
    lw, _ = pol.policy_logits(params, torch.from_numpy(obs), cfg)
    rlw, _ = ref_pol.policy_logits(rp, jnp.asarray(obs), rcfg)
    np.testing.assert_allclose(lw.numpy(), np.asarray(rlw), rtol=1e-5,
                               atol=1e-7)
    # and the generic tree functions read each other's files
    ref_ckpt.save(str(tmp_path / "g"), 1, {"x": np.arange(3.0)})
    out, _ = ckpt.restore(str(tmp_path / "g"), 1, {"x": torch.zeros(3)})
    assert out["x"].tolist() == [0.0, 1.0, 2.0]
