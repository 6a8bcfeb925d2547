"""In-loop deblocking filter (H.265 8.7.2), whole picture at once
(counterpart of kvazzup_tpu/ops/deblock.py).

All vertical edges are filtered first, then all horizontal edges on the
result, each as one batched expression over (edges x lines).  Boundary
strengths come per edge and block of `spacing` samples (the CTB16 path:
uniform along each CTB edge), or per 4-sample segment (`bs_rep=4`, the
quadtree P pictures); the quadtree paths filter on the 8-sample grid,
where chroma takes every second edge (`chroma_every=2`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tables import CHROMA_QP_TABLE
from ..runtime import device_const

# Table 8-12 (beta') and tc'
BETA_TABLE = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
       30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
    dtype=np.int32,
)
TC_TABLE = np.array(
    [0] * 18
    + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
       6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32,
)


def compute_bs(ctype, cbf_y, mvs, cw: int, ch: int):
    """Per-edge boundary strengths (8.7.2.4): 2 on intra edges, 1 on
    cbf / MV-discontinuity edges, else 0.

    ctype: (nctu,) with 0 == intra; cbf_y: (nctu,) bool; mvs: (nctu, 2).
    Returns (bs_v (cw-1, ch), bs_h (ch-1, cw)) int32."""
    is_intra = (ctype == 0).reshape(ch, cw)
    cbf = cbf_y.reshape(ch, cw)
    mv = mvs.reshape(ch, cw, 2)

    def pair_bs(ia, ib, ca, cb, ma, mb):
        mv_edge = ((ma - mb).abs() >= 4).any(dim=-1)
        one = torch.where(ca | cb | mv_edge, 1, 0)
        return torch.where(ia | ib, 2, one).to(torch.int32)

    bs_v = pair_bs(is_intra[:, :-1], is_intra[:, 1:], cbf[:, :-1], cbf[:, 1:],
                   mv[:, :-1], mv[:, 1:]).T.contiguous()
    bs_h = pair_bs(is_intra[:-1], is_intra[1:], cbf[:-1], cbf[1:], mv[:-1], mv[1:])
    return bs_v, bs_h


def _luma_edge_filter(s, beta, tc, gate, mx: int = 255):
    """s: (E, L, 8) int32 slabs [p3 p2 p1 p0 q0 q1 q2 q3] across E edges of
    L lines (L a multiple of 4); beta, tc: (E, L); gate: (E, L) bool."""
    p3, p2, p1, p0 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    q0, q1, q2, q3 = s[..., 4], s[..., 5], s[..., 6], s[..., 7]

    shape4 = s.shape[:-2] + (s.shape[-2] // 4, 4)

    def g(x):
        return x.reshape(shape4)

    gp3, gp2, gp1, gp0 = g(p3), g(p2), g(p1), g(p0)
    gq0, gq1, gq2, gq3 = g(q0), g(q1), g(q2), g(q3)
    beta_g = g(beta)[..., 0]
    tc_g = g(tc)[..., 0]
    gate_g = g(gate)[..., 0]

    dp = (gp2 - 2 * gp1 + gp0).abs()
    dq = (gq2 - 2 * gq1 + gq0).abs()
    dp0, dp3 = dp[..., 0], dp[..., 3]
    dq0, dq3 = dq[..., 0], dq[..., 3]
    filter_on = (dp0 + dq0 + dp3 + dq3 < beta_g) & gate_g

    def strong_cond(i):
        c1 = 2 * (dp[..., i] + dq[..., i]) < (beta_g >> 2)
        c2 = ((gp3[..., i] - gp0[..., i]).abs()
              + (gq0[..., i] - gq3[..., i]).abs()) < (beta_g >> 3)
        c3 = (gp0[..., i] - gq0[..., i]).abs() < ((5 * tc_g + 1) >> 1)
        return c1 & c2 & c3

    strong = strong_cond(0) & strong_cond(3)

    def up(m):
        return m.repeat_interleave(4, dim=-1)

    filter_on_l = up(filter_on)
    strong_l = up(strong)

    def clip(x, c):
        return torch.minimum(torch.maximum(x, -c), c)

    def cl1(x):
        return x.clamp(0, mx)

    tc2x = 2 * tc
    sp0 = p0 + clip(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, tc2x)
    sp1 = p1 + clip(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, tc2x)
    sp2 = p2 + clip(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2, tc2x)
    sq0 = q0 + clip(((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3) - q0, tc2x)
    sq1 = q1 + clip(((q2 + q1 + q0 + p0 + 2) >> 2) - q1, tc2x)
    sq2 = q2 + clip(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2, tc2x)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = delta.abs() < 10 * tc
    dlt = clip(delta, tc)
    wp0 = cl1(p0 + dlt)
    wq0 = cl1(q0 - dlt)
    side_thresh = (beta_g + (beta_g >> 1)) >> 3
    dEp = up((dp0 + dp3) < side_thresh)
    dEq = up((dq0 + dq3) < side_thresh)
    tc2 = tc >> 1
    wp1 = cl1(p1 + clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, tc2))
    wq1 = cl1(q1 + clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, tc2))

    weak_act = filter_on_l & ~strong_l & weak_on
    strong_act = filter_on_l & strong_l
    np0 = torch.where(strong_act, cl1(sp0), torch.where(weak_act, wp0, p0))
    nq0 = torch.where(strong_act, cl1(sq0), torch.where(weak_act, wq0, q0))
    np1 = torch.where(strong_act, cl1(sp1), torch.where(weak_act & dEp, wp1, p1))
    nq1 = torch.where(strong_act, cl1(sq1), torch.where(weak_act & dEq, wq1, q1))
    np2 = torch.where(strong_act, cl1(sp2), p2)
    nq2 = torch.where(strong_act, cl1(sq2), q2)
    return torch.stack([np2, np1, np0, nq0, nq1, nq2], dim=-1)


def _chroma_edge_filter(s, tc, gate, mx: int = 255):
    """s: (E, L, 4) = [p1 p0 q0 q1]; bS == 2 edges only (gate)."""
    p1, p0, q0, q1 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3)
    delta = torch.minimum(torch.maximum(delta, -tc), tc)
    np0 = torch.where(gate, (p0 + delta).clamp(0, mx), p0)
    nq0 = torch.where(gate, (q0 - delta).clamp(0, mx), q0)
    return torch.stack([np0, nq0], dim=-1)


def _tc_of(idx):
    t = device_const("tc_table", lambda: TC_TABLE, idx.device, torch.int32)
    return t[idx.long()]


def _filter_plane(p, bs_v, bs_h, spacing: int, taps: int, edge_fn):
    """Filter vertical then horizontal edges at multiples of `spacing`.

    edge_fn(slabs, bs, vertical) -> the 2*(taps-1) filtered centre samples.
    bs_v: (n_v_edges, H/spacing), bs_h: (n_h_edges, W/spacing)."""
    h, w = p.shape
    dev = p.device
    half = taps // 2
    xe = torch.arange(spacing, w, spacing, device=dev)
    if len(xe):
        cols = (xe[:, None] + torch.arange(-half, half, device=dev)).reshape(-1)
        slabs = p[:, cols].reshape(h, len(xe), taps).permute(1, 0, 2)
        out = edge_fn(slabs, bs_v, True)
        wcols = (xe[:, None] + torch.arange(-half + 1, half - 1, device=dev)).reshape(-1)
        p[:, wcols] = out.permute(1, 0, 2).reshape(h, -1)
    ye = torch.arange(spacing, h, spacing, device=dev)
    if len(ye):
        rows = (ye[:, None] + torch.arange(-half, half, device=dev)).reshape(-1)
        slabs = p[rows, :].reshape(len(ye), taps, w).permute(0, 2, 1)
        out = edge_fn(slabs, bs_h, False)
        wrows = (ye[:, None] + torch.arange(-half + 1, half - 1, device=dev)).reshape(-1)
        p[wrows, :] = out.permute(0, 2, 1).reshape(-1, w)
    return p


def deblock_frame(y, u, v, qp: int, *, spacing: int = 16, bs_v=None, bs_h=None,
                  chroma_every: int = 1, bs_rep: int = 0, qp_map=None, bd: int = 8):
    """Deblock one 8-bit picture with a uniform slice QP, zero beta/tc and
    chroma QP offsets, and per-edge bS maps (None = every edge bS 2).

    y: (H, W) uint8; u, v: (H/2, W/2).  bs_v: (n_v_edges, H / rep), bs_h:
    (n_h_edges, W / rep) with rep = bs_rep or spacing.  Chroma filters
    every `chroma_every`-th edge (its 8-sample grid) where bS is 2; with
    4-sample bS it takes the larger of each luma pair.  Returns the
    filtered planes as uint8.  Per-block QP maps and bit depths other
    than 8 are not ported."""
    if qp_map is not None:
        raise NotImplementedError("deblocking with a per-block QP map is not ported")
    if bd != 8:
        raise NotImplementedError(f"deblocking at bit depth {bd} is not ported (8 only)")
    mx = 255
    dev = y.device
    qp = int(qp)
    beta = int(BETA_TABLE[min(max(int(qp), 0), 51)])
    rep = bs_rep or spacing  # bS granularity along an edge

    def full_bs(n_edges, n_blocks):
        return torch.full((n_edges, n_blocks), 2, dtype=torch.int32, device=dev)

    def luma_edges(slabs, bs, vertical):
        if bs is None:
            bs = full_bs(slabs.shape[0], slabs.shape[1] // rep)
        bs_l = bs.repeat_interleave(rep, dim=1)
        tc = _tc_of((qp + 2 * (bs_l.clamp(min=1) - 1)).clamp(0, 53))
        beta_l = torch.full_like(tc, beta)
        return _luma_edge_filter(slabs, beta_l, tc, bs_l > 0, mx)

    ry = _filter_plane(y.to(torch.int32, copy=True), bs_v, bs_h, spacing, 8, luma_edges)

    sp = spacing // 2
    qpc = int(CHROMA_QP_TABLE[min(max(int(qp), 0), 57)])
    tc_c = int(TC_TABLE[min(max(qpc + 2, 0), 53)])

    def chroma(c):
        def edges(slabs, bs, vertical):
            if bs is None:
                bs = full_bs(slabs.shape[0], slabs.shape[1] // sp)
            elif rep != spacing:
                bs = torch.maximum(bs[:, 0::2], bs[:, 1::2])
            on_grid = (torch.arange(1, bs.shape[0] + 1, device=dev) % chroma_every) == 0
            gate = ((bs == 2) & on_grid[:, None]).repeat_interleave(sp, dim=1)
            tct = torch.full(gate.shape, tc_c, dtype=torch.int32, device=dev)
            return _chroma_edge_filter(slabs, tct, gate, mx)

        return _filter_plane(c.to(torch.int32, copy=True), bs_v, bs_h, sp, 4, edges)

    return ry.to(torch.uint8), chroma(u).to(torch.uint8), chroma(v).to(torch.uint8)
