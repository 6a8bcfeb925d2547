"""Motion compensation: HEVC sub-pel interpolation (8.5.4.2) over per-CTU
reference windows (counterpart of kvazzup_tpu/ops/mc.py).

Luma 8-tap and chroma 4-tap filters, horizontal then vertical, in the
normative 14-bit intermediate domain.  Reference edge extension is edge
padding.  Per-lane sub-windows are selected with `torch.gather` (the JAX
package spells the same selection as one-hot matmuls to avoid TPU gathers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import device_const

# Table 8-11: luma interpolation coefficients per quarter-pel phase
LUMA_FILTERS = np.array(
    [
        [0, 0, 0, 64, 0, 0, 0, 0],
        [-1, 4, -10, 58, 17, -5, 1, 0],
        [-1, 4, -11, 40, 40, -11, 4, -1],
        [0, 1, -5, 17, 58, -10, 4, -1],
    ],
    dtype=np.int32,
)
# Table 8-13: chroma interpolation coefficients per eighth-pel phase
CHROMA_FILTERS = np.array(
    [
        [0, 64, 0, 0],
        [-2, 58, 10, -2],
        [-4, 54, 16, -2],
        [-6, 46, 28, -4],
        [-4, 36, 36, -4],
        [-4, 28, 46, -6],
        [-2, 16, 54, -4],
        [-2, 10, 58, -2],
    ],
    dtype=np.int32,
)

LUMA_PAD = 4  # taps reach [-3, +4] around the integer position
CHROMA_PAD = 2


def edge_pad(plane, pad):
    """Edge-replicated padding of an (H, W) plane; pad = p or ((t, b), (l, r))."""
    (t, b), (l, r) = ((pad, pad), (pad, pad)) if isinstance(pad, int) else pad
    h, w = plane.shape
    dev = plane.device
    rows = torch.arange(-t, h + b, device=dev).clamp(0, h - 1)
    cols = torch.arange(-l, w + r, device=dev).clamp(0, w - 1)
    return plane[rows][:, cols]


def uni_round(p14):
    """14-bit -> sample domain for uni-prediction: (p + 32) >> 6, clip."""
    return ((p14 + 32) >> 6).clamp(0, 255)


def bi_round(p14_l0, p14_l1):
    """Default bi-prediction combine (8.5.4.2.3): (L0 + L1 + 64) >> 7 of
    two 14-bit predictions, clipped to the sample range."""
    return ((p14_l0 + p14_l1 + 64) >> 7).clamp(0, 255)


def mc_window_origin(search_range: int, chroma: bool = False) -> int:
    return (search_range // 2 if chroma else search_range) + (1 if chroma else 3)


def _win_geom(n: int, search_range: int, chroma: bool):
    taps_lo, taps_hi = (1, 2) if chroma else (3, 4)
    rng = search_range // 2 if chroma else search_range
    return taps_lo, rng, n + 2 * rng + taps_lo + taps_hi


def extract_windows_static(ref_pad, n: int, win: int, cw: int, ch: int,
                           pad: int, lo: int, rng: int):
    """(nctu, win, win) windows on the static n-strided CTU grid; CTU
    (r, c)'s window starts at (pad + n*r - rng - lo, pad + n*c - rng - lo)."""
    off = pad - rng - lo
    dev = ref_pad.device
    span = torch.arange(win, device=dev)
    ri = off + n * torch.arange(ch, device=dev)[:, None] + span  # (ch, win)
    ci = off + n * torch.arange(cw, device=dev)[:, None] + span  # (cw, win)
    blocks = ref_pad[ri[:, None, :, None], ci[None, :, None, :]]  # (ch, cw, win, win)
    return blocks.reshape(ch * cw, win, win)


def extract_mc_neighborhoods(ref_pad, n: int, search_range: int, cw: int,
                             ch: int, pad: int, chroma: bool = False):
    """Per-CTU reference neighbourhoods covering every |MV| <= search_range."""
    lo, rng, win = _win_geom(n, search_range, chroma)
    return extract_windows_static(ref_pad, n, win, cw, ch, pad, lo, rng)


def sheared_ref_strips(ref_pad, n: int, search_range: int, ch: int, pad: int,
                       chroma: bool = False):
    """Per-lane reference strips, sheared so that wave d's windows are the
    column range [n*d, n*d + win) of every lane (lane k = CTU row k of the
    row-aligned schedule, whose CTU column is d - 2k).

    Returns (ch, win, 2n*(ch-1) + W_pad - off), zeros outside each strip."""
    lo, rng, win = _win_geom(n, search_range, chroma)
    off = pad - rng - lo
    w = ref_pad.shape[1]
    shear = 2 * n
    total = shear * (ch - 1) + (w - off)
    out = torch.zeros((ch, win, total), dtype=ref_pad.dtype, device=ref_pad.device)
    for k in range(ch):
        y0 = off + n * k
        out[k, :, shear * k:shear * k + (w - off)] = ref_pad[y0:y0 + win, off:]
    return out


def strip_window_slice(strips, d: int, n: int, search_range: int,
                       chroma: bool = False):
    """Wave d's per-lane MC windows (lanes, win, win), a view of the strips.
    The start is clamped into range like the reference's dynamic slice."""
    _, _, win = _win_geom(n, search_range, chroma)
    start = min(max(n * d, 0), strips.shape[2] - win)
    return strips[:, :, start:start + win]


def window_select_batch(wins, oy, ox, oh: int, ow: int,
                        channels_last: bool = False):
    """Per-lane (oh, ow) sub-windows at offsets (oy, ox) of (L, Hw, Ww)
    windows, as int32.  Samples outside a window read as 0.
    channels_last: return (oh, ow, L)."""
    L, hw, ww = wins.shape
    dev = wins.device
    ri = oy[:, None].long() + torch.arange(oh, device=dev)  # (L, oh)
    ci = ox[:, None].long() + torch.arange(ow, device=dev)  # (L, ow)
    rows = wins.gather(1, ri.clamp(0, hw - 1)[:, :, None].expand(L, oh, ww))
    out = rows.gather(2, ci.clamp(0, ww - 1)[:, None, :].expand(L, oh, ow))
    ok = (((ri >= 0) & (ri < hw))[:, :, None]
          & ((ci >= 0) & (ci < ww))[:, None, :])
    out = torch.where(ok, out.to(torch.int32), 0)
    return out.permute(1, 2, 0) if channels_last else out


def _phase_coeffs(frac, chroma: bool):
    """(L,) phase indices -> (L, taps) int32 filter rows."""
    table = CHROMA_FILTERS if chroma else LUMA_FILTERS
    t = device_const(("mc_filters", chroma), lambda: table, frac.device, torch.int32)
    return t[frac.long()]


def _filter_2d(w, cfh, cfv, size: int, taps: int):
    acc = torch.zeros((w.shape[0], size + taps - 1, size), dtype=torch.int32,
                      device=w.device)
    for k in range(taps):
        acc += cfh[:, k, None, None] * w[:, :, k:k + size]
    out = torch.zeros((w.shape[0], size, size), dtype=torch.int32, device=w.device)
    for k in range(taps):
        out += cfv[:, k, None, None] * acc[:, k:k + size, :]
    return out >> 6


def mc_luma_window_batch_14bit(wins, mvs, size: int, search_range: int):
    """Batched luma MC in the 14-bit domain: (L, Hw, Ww) windows, (L, 2)
    quarter-pel MVs -> (L, size, size)."""
    org = mc_window_origin(search_range, False)
    ix = org + (mvs[:, 0] >> 2) - 3
    iy = org + (mvs[:, 1] >> 2) - 3
    w = window_select_batch(wins, iy, ix, size + 7, size + 7)
    return _filter_2d(w, _phase_coeffs(mvs[:, 0] & 3, False),
                      _phase_coeffs(mvs[:, 1] & 3, False), size, 8)


def mc_luma_window_batch(wins, mvs, size: int, search_range: int):
    return uni_round(mc_luma_window_batch_14bit(wins, mvs, size, search_range))


def mc_chroma_window_batch_14bit(wins, mvs, size: int, search_range: int):
    """Batched chroma MC (4-tap, eighth-pel phases) in the 14-bit domain."""
    org = mc_window_origin(search_range, True)
    ix = org + (mvs[:, 0] >> 3) - 1
    iy = org + (mvs[:, 1] >> 3) - 1
    w = window_select_batch(wins, iy, ix, size + 3, size + 3)
    return _filter_2d(w, _phase_coeffs(mvs[:, 0] & 7, True),
                      _phase_coeffs(mvs[:, 1] & 7, True), size, 4)


def mc_chroma_window_batch(wins, mvs, size: int, search_range: int):
    return uni_round(mc_chroma_window_batch_14bit(wins, mvs, size, search_range))
