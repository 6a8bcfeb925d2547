"""Integer + fractional motion estimation as dense frame-level passes
(counterpart of kvazzup_tpu/ops/me.py, untiled form).

Three stages over every 16x16 block at once: full-search SAD at half
resolution (+-R/2 half-res offsets), a +-2 full-pel refinement, then a
7x7 quarter-pel sweep with the normative 8-tap filters.  The MV cost is
lambda times an exp-Golomb-like bit estimate (`costs.bits_of`), truncated
to an integer as in the reference.  All sums are integer reshape-sums.
"""

from __future__ import annotations

import torch

from .costs import bits_of
from .mc import LUMA_FILTERS, edge_pad, extract_windows_static, window_select_batch


def _mv_cost(lam, mvx, mvy):
    return (lam * (bits_of(mvx) + bits_of(mvy))).to(torch.int32)


def _half(x, h2: int, w2: int):
    """2x2 mean (rounded) of an int32 plane."""
    s = x.reshape(h2, 2, w2, 2).sum(dim=(1, 3), dtype=torch.int32)
    return (s + 2) >> 2


def motion_search(orig_y, ref_y, lam_x1k, *, block: int = 16,
                  search_range: int = 16, width: int, height: int,
                  xtile=(False, False)):
    """Full-frame motion search.  orig_y/ref_y: (H, W) uint8 tensors;
    lam_x1k: lambda * 1024 as an integer.  Motion-constrained tiles
    (`xtile`) are not ported.

    Returns (mv_qpel (nctu, 2) int32 [x, y], cost (nctu,) int32)."""
    if any(xtile):
        raise NotImplementedError("motion-constrained tiles are not ported")
    dev = orig_y.device
    bs = block
    cw, ch = width // bs, height // bs
    nctu = cw * ch
    lam = torch.full((), float(lam_x1k), dtype=torch.float32, device=dev) / 1024.0
    orig = orig_y.to(torch.int32)

    # ---- stage 1: full search at half resolution, offsets +-R/2
    h2, w2 = height // 2, width // 2
    oh = _half(orig, h2, w2)
    rh = _half(ref_y.to(torch.int32), h2, w2)
    r2 = search_range // 2
    rh_pad = edge_pad(rh, r2)
    side = 2 * r2 + 1
    hb = bs // 2
    sads = torch.empty((side, side, ch, cw), dtype=torch.int32, device=dev)
    for dyi in range(side):
        strip = rh_pad[dyi:dyi + h2]
        shifted = torch.stack([strip[:, dxi:dxi + w2] for dxi in range(side)])
        d = (oh[None] - shifted).abs()
        sads[dyi] = d.reshape(side, ch, hb, cw, hb).sum(dim=(2, 4), dtype=torch.int32)
    dxy = torch.arange(side, dtype=torch.int32, device=dev) - r2
    b8 = bits_of(8 * dxy)
    mvb = (lam * (b8[None, :] + b8[:, None])).to(torch.int32)
    flat = (sads * 4 + mvb[..., None, None]).reshape(side * side, nctu)
    best_i = flat.argmin(dim=0).to(torch.int32)
    best_mv = torch.stack([2 * (best_i % side - r2), 2 * (best_i // side - r2)], dim=1)

    # ---- stage 2: +-2 full-pel refinement in a (bs+12)^2 window around the
    # stage-1 anchor (clamped to +-(R-2) so the window stays in the
    # per-CTU static windows); channels-last (i, j, ctu)
    pad2 = search_range + 4
    ref_pad8 = edge_pad(ref_y, pad2)
    orig_t = orig.reshape(ch, bs, cw, bs).permute(1, 3, 0, 2).reshape(bs, bs, nctu)
    win_side = bs + 2 * (search_range + 4)
    wins = extract_windows_static(ref_pad8, bs, win_side, cw, ch, pad2, 4, search_range)
    org_s = search_range + 4
    best_mv = best_mv.clamp(-(search_range - 2), search_range - 2)
    win23 = window_select_batch(wins, best_mv[:, 1] + org_s - 6,
                                best_mv[:, 0] + org_s - 6, bs + 12, bs + 12,
                                channels_last=True)
    best_cost = torch.full((nctu,), 1 << 30, dtype=torch.int32, device=dev)
    best_dx = torch.zeros((nctu,), dtype=torch.int32, device=dev)
    best_dy = torch.zeros_like(best_dx)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            cand = win23[6 + dy:6 + dy + bs, 6 + dx:6 + dx + bs, :]
            sad = (orig_t - cand).abs().sum(dim=(0, 1), dtype=torch.int32)
            cost = sad + _mv_cost(lam, 4 * (best_mv[:, 0] + dx), 4 * (best_mv[:, 1] + dy))
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_dx = torch.where(better, dx, best_dx)
            best_dy = torch.where(better, dy, best_dy)
    best_d = torch.stack([best_dx, best_dy], dim=1)
    int_mv = (best_mv + best_d).clamp(-(search_range - 1), search_range - 1)

    # ---- stage 3: every quarter-pel offset in [-3, 3]^2 around int_mv,
    # from the (bs+8)^2 window re-anchored by the stage-2 shift
    sh = int_mv - best_mv
    rows3 = torch.zeros((bs + 8, bs + 12, nctu), dtype=torch.int32, device=dev)
    for s in range(5):
        rows3 += torch.where((sh[:, 1] == s - 2)[None, None, :], win23[s:s + bs + 8], 0)
    win3 = torch.zeros((bs + 8, bs + 8, nctu), dtype=torch.int32, device=dev)
    for s in range(5):
        win3 += torch.where((sh[:, 0] == s - 2)[None, None, :], rows3[:, s:s + bs + 8], 0)
    qx = 4 * int_mv[:, 0]
    qy = 4 * int_mv[:, 1]

    def horiz_at(sx: int):
        ox = 4 + (sx >> 2)
        fx = sx & 3
        if fx == 0:
            return win3[:, ox:ox + bs, :] * 64
        acc = torch.zeros((bs + 8, bs, nctu), dtype=torch.int32, device=dev)
        for k, c in enumerate(LUMA_FILTERS[fx].tolist()):
            acc += c * win3[:, ox - 3 + k:ox - 3 + k + bs, :]
        return acc

    cand0 = win3[4:4 + bs, 4:4 + bs, :]
    best_cost_q = (orig_t - cand0).abs().sum(dim=(0, 1), dtype=torch.int32) + _mv_cost(lam, qx, qy)
    best_mv_q = torch.stack([qx, qy], dim=1)
    for sx in range(-3, 4):
        horiz = horiz_at(sx)
        for sy in range(-3, 4):
            if sx == 0 and sy == 0:
                continue
            oy = 4 + (sy >> 2)
            fy = sy & 3
            if fy == 0:
                pred = ((horiz[oy:oy + bs] + 32) >> 6).clamp(0, 255)
            else:
                acc = torch.zeros((bs, bs, nctu), dtype=torch.int32, device=dev)
                for k, c in enumerate(LUMA_FILTERS[fy].tolist()):
                    acc += c * horiz[oy - 3 + k:oy - 3 + k + bs]
                pred = (((acc >> 6) + 32) >> 6).clamp(0, 255)
            sad = (orig_t - pred).abs().sum(dim=(0, 1), dtype=torch.int32)
            mvx, mvy = qx + sx, qy + sy
            cost = sad + _mv_cost(lam, mvx, mvy)
            better = cost < best_cost_q
            best_cost_q = torch.where(better, cost, best_cost_q)
            best_mv_q = torch.where(better[:, None], torch.stack([mvx, mvy], dim=1), best_mv_q)
    return best_mv_q, best_cost_q
