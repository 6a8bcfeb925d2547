"""kvazzup_tpu_torch — the HEVC encoder of kvazzup_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The JAX package `kvazzup_tpu` is the reference: every module here mirrors
one of its `ops/` or `encoder/` modules and is held element-identical (ops)
or byte-identical (streams) against it.  Framework-free modules (core
tables and parameter sets, the native CABAC writer, the wavefront schedule,
YUV I/O) are imported from `kvazzup_tpu` rather than copied.

Scope: the CLI's default low-delay encode (CTB16, IDR + P, deblocking).
"""

from . import runtime  # noqa: F401  (fixes the float32 matmul precision)

__version__ = "0.1.0"
