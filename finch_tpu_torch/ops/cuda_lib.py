"""Build and load the port's CUDA sources (``finch_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``csrc/_build/`` (listed in
``.gitignore``), keyed by a hash of the source and of the headers beside it
(``csrc/*.cuh``) so that an edit rebuilds and an unchanged source is
reused. The wrappers in ``ops/`` load it with
ctypes. Nothing here runs when a module is imported: machines without the
CUDA toolkit import every module and use the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from finch_tpu_torch.errors import FinchMessageError

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
SOURCES = ("extract", "dedup")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FinchMessageError("nvcc not found: the CUDA toolkit is needed "
                                "to build the kernels in csrc/")
    return found


def build(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu into csrc/_build (keyed by a content hash).

    Returns (path of the shared library, compiler output). The output holds
    ptxas' registers, shared memory and spills per kernel; it is empty when
    the cached library is reused."""
    src = os.path.join(CSRC, f"{name}.cu")
    sha = hashlib.sha256()
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(so_path):
        return so_path, ""
    tmp = so_path + f".tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise FinchMessageError(
            f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path, proc.stdout + proc.stderr


def function(name: str, fn: str, declare):
    """The ctypes function `fn` of csrc/<name>.cu. The library is built and
    loaded once (`declare(lib)` sets its functions' argument and result
    types) and the function resolved once."""
    f = _fns.get((name, fn))
    if f is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(build(name)[0])
                declare(lib)
                _libs[name] = lib
            f = _fns[(name, fn)] = getattr(lib, fn)
    return f


def launch(fn, dev: torch.device, *args) -> int:
    """Call the launcher `fn(*args, stream)` on `dev`'s current stream,
    switching the current device only when `dev` is not it. Returns the
    launcher's CUDA error code."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, _stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _stream(dev))


def count(wrapper, name: str = "launches") -> None:
    """Add one to the launch counter `wrapper.<name>`. One lock serves
    every wrapper: the mesh's shards launch from several threads, and an
    unlocked `+= 1` on an attribute can lose an increment."""
    with _count_lock:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _stream(dev: torch.device) -> int:
    # the raw handle in one call (torch.cuda.current_stream builds a Stream
    # object first)
    return torch._C._cuda_getCurrentRawStream(dev.index)
