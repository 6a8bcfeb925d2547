"""Device rules and the hand-written kernel library.

Importing this module fixes the float32 matmul precision: the codec does
exact integer arithmetic as f32 matrix products whose partial sums stay
below 2^24 (`ops/ctu_kernels.py`), which TF32 would round.

The CUDA kernels in `csrc/` are compiled on first use with plain `nvcc`
(one process per source, all started together) and linked into one shared
library with a C interface (`build/`, content-addressed), loaded with
ctypes.  There is no CPU fallback for a CUDA tensor: a missing card,
compiler or failed launch raises.
"""

from __future__ import annotations

import contextlib
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
KERNEL_SOURCES = ("q_kernels.cu", "sao_kernels.cu", "resid_kernels.cu", "merge_kernels.cu")
KERNEL_HEADERS = ("satd_warp.cuh",)  # included by the sources; part of the build hash
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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


def _wait(procs) -> list:
    """Wait for every (name, Popen) and return their stderr texts; raise
    with the compiler's output if any failed."""
    errs, failed = [], []
    for name, proc in procs:
        _, err = proc.communicate()
        errs.append(f"{name}:\n{err}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return errs


def _nvcc_proc(args):
    return subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def build_kernels(verbose: bool = False) -> str:
    """Compile `csrc/*.cu` for sm_90a into build/; return the library path.

    Each source compiles in its own nvcc process, all at once; the objects
    are then linked into one library.  The file name carries a hash of the
    sources, headers and flags, so an edited kernel never loads a stale
    build."""
    srcs = [os.path.join(CSRC_DIR, s) for s in KERNEL_SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(CSRC_DIR, s) for s in KERNEL_HEADERS]:
        with open(s, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libkvz_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    pid = os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.{pid}.o") for s in srcs]
    xptxas = ["-Xptxas", "-v"] if verbose else []
    try:
        errs = _wait([(os.path.basename(s), _nvcc_proc([*NVCC_FLAGS, *xptxas, "-c", s, "-o", o]))
                      for s, o in zip(srcs, objs)])
        if verbose:
            print("\n".join(errs), flush=True)
        tmp = f"{so}.{pid}.tmp"
        _wait([("link", _nvcc_proc(["-shared", "-o", tmp, *objs]))])
        os.replace(tmp, so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return so


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kvz_quant.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.kvz_dequant.argtypes = [p, p, p, i, i, i, i, p]
    lib.kvz_satd.argtypes = [p, p, p, i, i, i, p]
    lib.kvz_sao_apply.argtypes = [p, p, p, p, p, i, i, i, i] * 3 + [i, i, p]
    lib.kvz_code_residual.argtypes = [p, p, p, p, p, i, i] * 3 + [p, i, i, p]
    lib.kvz_merge_search.argtypes = [p, ll, ll, p, p, p, i, i, i, p, p, p, p, p]
    for fn in (lib.kvz_quant, lib.kvz_dequant, lib.kvz_satd, lib.kvz_sao_apply,
               lib.kvz_code_residual, lib.kvz_merge_search):
        fn.restype = ctypes.c_int
    return lib


def kernel_lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:  # every launch passes here: no lock once loaded
        return _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build_kernels()))
        return _LIB


def check_operand(t, name: str, ndim: int, shape=None, dtype=torch.int32) -> None:
    """Raise unless t is a contiguous `ndim`-D tensor of `dtype` (and of
    `shape`, when given): what a kernel's C entry point takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: expected a {ndim}-D tensor"
                         + (f" of shape {tuple(shape)}" if shape else "")
                         + f", got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def kernel_route(*ts) -> bool:
    """True to launch the CUDA kernel, False to run the plain version (CPU
    tensors).  Operands on different devices, or on a device type without
    a kernel, raise."""
    dev = {t.device for t in ts}
    if len(dev) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, dev))}")
    kind = next(iter(dev)).type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"no kernel for device type {kind!r}")
    return True


_NO_SWITCH = contextlib.nullcontext()


def on_device(t):
    """A context that makes t's CUDA device the current one for a launch;
    when it already is (the usual case), it does nothing, so a wave-loop
    launch pays no device switch."""
    idx = t.device.index
    return _NO_SWITCH if idx == torch.cuda.current_device() else torch.cuda.device(idx)


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current CUDA stream on t's device (the
    call PyTorch's own kernel launchers use: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
