"""What an encode starts from: the stream configuration and the frames.

Both come from framework-free modules of kvazzup_tpu (no JAX is imported):
the parameter sets of `kvazzup_tpu.core.params` and the YUV readers and the
seeded test-sequence generator of `kvazzup_tpu.io.yuv`.
"""

from __future__ import annotations

from kvazzup_tpu.core.params import StreamConfig
from kvazzup_tpu.io.yuv import psnr, read_y4m, read_yuv420, synthetic_frames

__all__ = ["StreamConfig", "psnr", "read_y4m", "read_yuv420", "stream_config",
           "synthetic_frames"]


def stream_config(width: int, height: int, *, qp: int = 32, deblock: bool = True,
                  merge: int = 1) -> StreamConfig:
    """The CLI-default low-delay CTB16 configuration for a width x height
    source (coded size padded to whole CTBs)."""
    return StreamConfig.for_source(width, height, qp=qp, deblocking_enabled=deblock,
                                   merge_cand=merge)
