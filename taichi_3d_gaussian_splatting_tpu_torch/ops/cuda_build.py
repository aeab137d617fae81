"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``_build/<name>-<hash>.so``, where the hash covers the source, the shared
headers and the compiler flags: an edited source builds anew, an unchanged
one is reused. A library is built at first use; ``build_all`` starts one
nvcc per source, all at once, and waits for them.

Flags: ``sm_90a`` (Hopper), ``-O3`` and no ``--use_fast_math``: the blend's
1/255 and 1e-4 thresholds compare ``expf`` results. ``-fmad=false`` keeps
multiply-adds unfused, so each kernel rounds exactly as its plain PyTorch
version (one rounded op per torch op) and the integer outputs that depend
on float tests (the expand kernel's cull) match bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
KERNEL_SOURCES = ("histogram", "expand", "blend", "blend_backward",
                  "segment_reduce", "stage_mark", "attributes", "adam")

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from source on the machine with the card")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=KERNEL_SOURCES) -> dict:
    """Build every missing library in parallel (one nvcc per source).
    Returns {name: seconds of its build, 0.0 when it was already built}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    secs = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The launch function ``fn`` of ``csrc/<name>.cu`` with its C
    signature declared (pointers and the stream as c_void_p, so ctypes
    passes them whole)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def require(t, name: str, dtype, ndim: int) -> None:
    """Validate a tensor handed to a kernel wrapper."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")
