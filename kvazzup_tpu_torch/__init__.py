"""kvazzup_tpu_torch — the HEVC encoder of kvazzup_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The JAX package `kvazzup_tpu` is the reference: every module here mirrors
one of its `ops/` or `encoder/` modules and is held element-identical (ops)
or byte-identical (streams) against it.  The port imports nothing of
`kvazzup_tpu`: the framework-free modules it needs (core tables and
parameter sets in `core/`, the CABAC writer and its native C library in
`entropy/` and `native/`, the wavefront schedule, YUV I/O in `io/`) are
copies of the JAX package's, at the same relative paths.

Scope: the CLI's low-delay encode at CTB16 and CTB64 (IDR + P, merge 1..5,
TMVP, deblocking, SAO, WPP, RDOQ), frame-level rate control
(`pipeline.rate_control`) and the frame-pipelined encoder
(`encoder.pipelined`).
"""

from . import runtime  # noqa: F401  (fixes the float32 matmul precision)

__version__ = "0.1.0"
