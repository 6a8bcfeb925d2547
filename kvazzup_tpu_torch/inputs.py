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
                  merge: int = 1, sao: bool = False, wpp: bool = False,
                  tmvp: bool = False, rdoq: bool = False, ctu: int = 16,
                  gop: str = "ld") -> StreamConfig:
    """The CLI's configuration for a width x height source
    (coded size padded to whole CTBs) at CTB `ctu` (16 or 64).  As in the
    JAX CLI, SAO turns WPP on at CTB16 (at CTB64 WPP is its own flag);
    CTB64 codes CUs of 64 down to 8 (min_cb_log2 3) with 32x32 transforms
    at most (max_tb_log2 5); `tmvp` turns temporal MV prediction on, `rdoq`
    rate-distortion optimized quantization.  `gop` "ra" is the CTB64
    random-access B pyramid (`encoder.ra_batch.QuadRABatchEncoder`), whose
    SPS allows 3 reordered pictures and 6 in the decoded picture buffer."""
    if ctu not in (16, 64):
        raise NotImplementedError(f"--ctu {ctu} is not ported (16 and 64 are)")
    if gop not in ("ld", "ra"):
        raise ValueError(f"gop must be 'ld' or 'ra', got {gop!r}")
    if gop == "ra" and ctu != 64:
        raise NotImplementedError("--gop ra is ported at --ctu 64 only (the CTB16 B engine "
                                  "is not)")
    ra = gop == "ra"
    ctb_log2 = {16: 4, 64: 6}[ctu]
    return StreamConfig.for_source(
        width, height, qp=qp, ctb_log2=ctb_log2, deblocking_enabled=deblock,
        merge_cand=merge, sao_enabled=sao, wpp=wpp or (sao and ctb_log2 == 4),
        temporal_mvp=tmvp, rdoq=rdoq,
        min_cb_log2=3 if ctb_log2 > 4 else 4, max_tb_log2=5 if ctb_log2 > 4 else 4,
        num_reorder_pics=3 if ra else 0, max_dec_pic_buffering=6 if ra else 2)
