"""Device rules and the hand-written kernel library.

Importing this module fixes the float32 matmul precision: the codec does
exact integer arithmetic as f32 matrix products whose partial sums stay
below 2^24 (`ops/ctu_kernels.py`), which TF32 would round.

The CUDA kernels in `csrc/` are compiled on first use with plain `nvcc`
into a shared library with a C interface (`build/`, content-addressed),
and loaded with ctypes.  There is no CPU fallback for a CUDA tensor: a
missing card, compiler or failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNEL_SOURCES = ("q_kernels.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
_CONSTS: dict = {}


def device_const(key, build, device, dtype) -> torch.Tensor:
    """The numpy constant `build()` as a `dtype` tensor on `device`, copied
    there once per (key, device, dtype) and reused: the hot loops index
    constant tables without a host-to-device copy (which PyTorch
    synchronises) per call."""
    k = (key, str(device), dtype)
    t = _CONSTS.get(k)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(build()), dtype=dtype, device=device)
        _CONSTS[k] = t
    return t


def require_cuda() -> torch.device:
    """The CUDA device, or a clear error when this process has no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kvazzup_tpu_torch: no CUDA device is visible to PyTorch "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda}); "
            "the GPU path needs an NVIDIA Hopper card")
    return torch.device("cuda", torch.cuda.current_device())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("kvazzup_tpu_torch: nvcc not found (CUDA_HOME, "
                           "/usr/local/cuda/bin, PATH)")
    return found


def build_kernels(verbose: bool = False) -> str:
    """Compile `csrc/*.cu` for sm_90a into build/; return the library path.

    The file name carries a hash of the sources and flags, so an edited
    kernel never loads a stale build."""
    srcs = [os.path.join(CSRC_DIR, s) for s in KERNEL_SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libkvz_q_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, flush=True)
    os.replace(tmp, so)
    return so


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kvz_quant.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.kvz_dequant.argtypes = [p, p, p, i, i, i, i, p]
    lib.kvz_satd.argtypes = [p, p, p, i, i, i, p]
    for fn in (lib.kvz_quant, lib.kvz_dequant, lib.kvz_satd):
        fn.restype = ctypes.c_int
    return lib


def kernel_lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build_kernels()))
        return _LIB
