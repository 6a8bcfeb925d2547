"""What the CTB64 B engine needs of the CTB16 B encoder (counterpart of
kvazzup_tpu/encoder/frame_b.py: `scale_mv` only; the CTB16 B encode itself
is not ported)."""

from __future__ import annotations

import torch


def scale_mv(mv, tb: int, td: int):
    """Temporal MV scaling (8.5.3.2.9), exact integer semantics: mv (..., 2)
    int32 scaled by the POC distances tb (current - target reference) and
    td (current - the neighbour's reference), both already clipped to
    [-128, 127] by the caller."""
    abs_td = abs(int(td))
    tx_mag = (16384 + (abs_td >> 1)) // max(abs_td, 1)
    tx = -tx_mag if td < 0 else tx_mag
    dsf = min(max((int(tb) * tx + 32) >> 6, -4096), 4095)
    prod = dsf * mv.to(torch.int32)
    return (torch.sign(prod) * ((prod.abs() + 127) >> 8)).clamp(-32768, 32767).to(torch.int32)
