"""Async, integrity-checked checkpoints of a tree of tensors, in the
reference's on-disk format (``repro/ckpt/checkpoint.py``), so that a
checkpoint written by either package loads in the other.

Layout per step directory::

  ckpt_<step>/
    manifest.json   {step, per leaf: shape, dtype, crc32; extra metadata}
    data.npz        flat leaf arrays, keyed by the leaf's "/"-joined path

* a save goes to a temporary directory published by an atomic rename, so
  a crash mid-write never corrupts the latest checkpoint;
* ``AsyncCheckpointer`` snapshots the tree to host arrays at the call and
  writes on a worker thread; ``wait()`` flushes;
* ``restore`` fills the structure of a target tree and places every
  tensor on the target leaf's device and dtype;
* ``keep_last`` bounds disk usage; the crc32 detects bit rot.

Trees are dicts (keys in sorted order), lists and tuples, walked with the
port's ``models/layers.py::tree_map``, the order ``jax.tree_util``
flattens them in; a leaf is a tensor or an array.
"""
from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.layers import tree_leaves, tree_map


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Any:
    """The tree with each leaf replaced by its "/"-joined path: dict keys,
    sequence indices and NamedTuple fields, as the reference names them."""
    if isinstance(tree, dict):
        return {k: _paths(tree[k], prefix + (str(k),)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        # a NamedTuple (the optimizer's state): ``.field``, as JAX names it
        return type(tree)(*(_paths(getattr(tree, f), prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(x, prefix + (str(i),))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return "/".join(prefix)


def _flatten(tree: Any) -> List[Tuple[str, np.ndarray]]:
    """``(path, host array)`` per leaf, in ``tree_map``'s order."""
    keys = tree_leaves(_paths(tree), lambda x: isinstance(x, str))
    return list(zip(keys, (_host(x) for x in tree_leaves(tree, _is_leaf))))


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep_last: int = 3) -> Path:
    """Write ``tree`` as ``ckpt_<step>`` under ``ckpt_dir``; keep the last
    ``keep_last`` steps.  Returns the published directory."""
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".tmp_ckpt_{step}"
    final = root / f"ckpt_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = _flatten(tree)
    np.savez(tmp / "data.npz", **dict(leaves))
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "crc32": _crc(v)} for k, v in leaves},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic publish
    steps = sorted(root.glob("ckpt_*"), key=lambda p: int(p.name.split("_")[1]))
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return final


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; ``wait()`` flushes and
    raises the last save's error, if any."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        # snapshot now: a copy, as a CPU tensor's array aliases it
        host_tree = tree_map(lambda x: np.array(_host(x)), tree, _is_leaf)

        def run():
            try:
                save(self.ckpt_dir, step, host_tree, extra, self.keep_last)
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("ckpt_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree: Any,
            verify: bool = True) -> Tuple[Any, Dict]:
    """``(tree, extra)``: step ``step`` in the structure of
    ``target_tree``, each tensor leaf on its target's device and dtype
    (an array leaf stays a host array of its target's dtype).  ``verify``
    checks every leaf's crc32 (``IOError`` on a mismatch)."""
    path = Path(ckpt_dir) / f"ckpt_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "data.npz")
    keys = iter(tree_leaves(_paths(target_tree), lambda x: isinstance(x, str)))

    def load(leaf):
        key = next(keys)
        arr = data[key]
        if verify and manifest["leaves"][key]["crc32"] != _crc(arr):
            raise IOError(f"checksum mismatch for {key}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                      dtype=leaf.dtype)
        return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr

    return tree_map(load, target_tree, _is_leaf), manifest["extra"]
