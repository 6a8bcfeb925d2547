"""Helpers of the CTB32 quadtree intra encoder that the CTB64 path shares
(counterpart of kvazzup_tpu/encoder/frame_intra32.py: `_subst_quad`; its
`_rd_prepass_grid` generalizes the CTB16 prepass and lives beside it as
`frame_intra.rd_prepass_grid`; the CTB32 encode itself is not ported).
"""

from __future__ import annotations

import torch

ZO = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx) quadrants in z-order


def subst_quad(bl, l, c, t, tr, f_bl, f_l, f_c, f_t, f_tr, bd: int = 8):
    """Reference substitution (8.4.4.2.2) with whole-segment availability.

    Segments in walk order: below-left (L, n), left (L, n), corner (L, 1),
    top (L, n), top-right (L, n); flags (L,) bool per segment.  Forward
    fill at segment granularity: an unavailable segment takes the running
    carry (the last sample of the last available one), segments before the
    first available one take its first sample; none available gives
    1 << (bd - 1).  Returns the (L, 4n + 1) walk."""
    def e(f):
        return f[:, None]

    mid = torch.full_like(c, 1 << (bd - 1))
    fv = torch.where(e(f_bl), bl[:, :1],
         torch.where(e(f_l), l[:, :1],
         torch.where(e(f_c), c,
         torch.where(e(f_t), t[:, :1],
         torch.where(e(f_tr), tr[:, :1], mid)))))
    blf = torch.where(e(f_bl), bl, fv)
    carry = torch.where(e(f_bl), bl[:, -1:], fv)
    lf = torch.where(e(f_l), l, carry)
    carry = torch.where(e(f_l), l[:, -1:], carry)
    cf = torch.where(e(f_c), c, carry)
    carry = cf
    tf = torch.where(e(f_t), t, carry)
    carry = torch.where(e(f_t), t[:, -1:], carry)
    trf = torch.where(e(f_tr), tr, carry)
    return torch.cat([blf, lf, cf, tf, trf], dim=-1)
