"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys
    sys.modules["jax"] = None

    class RefuseReference(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "repro" or name.startswith("repro."):
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, RefuseReference())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    assert callable(chip_smoke.main)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" and sys.modules[m] is not None
                    or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 58      # every module was imported


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
    assert not re.search(r"^\s*(import|from)\s+repro\b(?!_torch)", text,
                         re.M), path


def test_run_without_device_needs_cuda(monkeypatch):
    from repro_torch.sim import engine, workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = workload.make_cluster(T=10, H=2, K=2)
    jobs = workload.make_jobs(3, T=10, seed=0, small=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run(cluster, jobs)
    # a reactive baseline runs on the host, but resolves the device first
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run(cluster, jobs, scheduler="fifo")
