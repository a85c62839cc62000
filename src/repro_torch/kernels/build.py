"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (loaded with ``ctypes`` by the
kernel's module), cached under ``kernels/_build/`` by a hash of the
source and the flags, so a fresh checkout builds once and reuses it.
Several sources are compiled by concurrent ``nvcc`` processes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: the kernels' exactness contract with their plain versions
# forbids contracting a multiply and an add into one rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build_libraries(sources: Sequence[Path]) -> List[Path]:
    """Compile every source not yet built, all ``nvcc`` processes started
    together; returns the library paths in input order.  The compiler's
    resource report (``-Xptxas -v``) is kept beside each library as
    ``<name>.log``.  Raises RuntimeError with nvcc's output on failure."""
    libs = [library_path(Path(s)) for s in sources]
    todo: Dict[Path, Tuple[Path, subprocess.Popen]] = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    for src, lib in zip(sources, libs):
        if lib.exists() or lib in todo:
            continue
        # compile to a private name, then rename: a concurrent build of the
        # same source never sees a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        todo[lib] = tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for lib, (tmp, proc) in todo.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.name}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def bind(path: Path, functions: Dict[str, Sequence], error: str
         ) -> ctypes.CDLL:
    """Load the library at ``path`` and declare each exported function
    (``name -> argtypes``, each returning an int status) and its
    ``error`` string function (status -> message)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    getattr(lib, error).argtypes = [ctypes.c_int]
    getattr(lib, error).restype = ctypes.c_char_p
    return lib


def launch(lib: ctypes.CDLL, name: str, error: str, device: torch.device,
           *args) -> None:
    """Call the library's ``name`` with ``args`` and the current stream of
    ``device``; raise RuntimeError with the ``error`` function's message
    when it returns a non-zero launch status."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, error)(rc).decode())
