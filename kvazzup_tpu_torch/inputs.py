"""What an encode starts from: the stream configuration and the frames.

Both come from the port's copies of the JAX package's framework-free
modules: the parameter sets of `core.params` and the YUV readers and the
seeded test-sequence generator of `io.yuv`.
"""

from __future__ import annotations

from .core.params import StreamConfig
from .io.yuv import psnr, read_y4m, read_yuv420, synthetic_frames

__all__ = ["StreamConfig", "psnr", "read_y4m", "read_yuv420", "stream_config",
           "synthetic_frames"]


def stream_config(width: int, height: int, *, qp: int = 32, deblock: bool = True,
                  merge: int = 1, sao: bool = False, wpp: bool = False) -> StreamConfig:
    """The CLI's low-delay CTB16 configuration for a width x height source
    (coded size padded to whole CTBs).  As in the JAX CLI, SAO turns WPP on
    at CTB16."""
    return StreamConfig.for_source(width, height, qp=qp, deblocking_enabled=deblock,
                                   merge_cand=merge, sao_enabled=sao, wpp=wpp or sao)
