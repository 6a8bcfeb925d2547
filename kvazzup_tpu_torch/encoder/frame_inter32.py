"""Helpers of the CTB32 quadtree P encoder that the CTB64 path shares
(counterpart of kvazzup_tpu/encoder/frame_inter32.py: `_merge_list_cells`,
`_amvp_cells`, `_arbitrate` and the host functions `_walk_p_leaves`,
`quad_p_bs_maps`, `quad_p_cell_maps`; its `_cost_prepass_grid` is
`frame_intra.cost_prepass_grid`, its `_code_flat_mode` the residual
wrappers' per-row intra flags, and the CTB32 encode itself is not
ported).

Merge and AMVP lists come from per-position (avail, mv) pairs at 16x16
motion-cell granularity, single reference; the arbitration SATD-costs
every merge candidate's MC and the ME vector's in one batched MC and one
SATD call, and picks intra, merge or AMVP.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ctu_kernels as ck
from ..ops.costs import fma
from ..ops.mc import mc_luma_window_batch
from ..runtime import device_const
from .frame_inter import SEARCH_RANGE, amvp_list, amvp_list_t, first_inter_mv, mvd_bits
from .frame_intra32 import ZO


def merge_list_cells(cands, k: int, temporal=None):
    """Spec merge list (8.5.3.2.3) from per-position (avail (L,), mv (L, 2))
    pairs a1, b1, b0, a0, b2: B2 only when fewer than 4 earlier
    candidates, pruning pairs per spec, then the temporal candidate when
    given as (avail, mv) -- appended after B2, never pruned -- and zero-MV
    fill (one reference).  Returns k (L, 2) candidate MVs."""
    (va1, ma1), (vb1, mb1) = cands["a1"], cands["b1"]
    (vb0, mb0), (va0, ma0) = cands["b0"], cands["a0"]
    vb2, mb2 = cands["b2"]

    def eq(a, b):
        return (a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1])

    def i32(f):
        return f.to(torch.int32)

    p_a1 = va1
    p_b1 = vb1 & ~(va1 & eq(mb1, ma1))
    p_b0 = vb0 & ~(vb1 & eq(mb0, mb1))
    p_a0 = va0 & ~(va1 & eq(ma0, ma1))
    nfirst4 = i32(p_a1) + i32(p_b1) + i32(p_b0) + i32(p_a0)
    p_b2 = (nfirst4 < 4) & vb2 & ~(va1 & eq(mb2, ma1)) & ~(vb1 & eq(mb2, mb1))
    pos_b1 = i32(p_a1)
    pos_b0 = pos_b1 + i32(p_b1)
    pos_a0 = pos_b0 + i32(p_b0)
    pos_b2 = pos_a0 + i32(p_a0)
    pos_t = pos_b2 + i32(p_b2)
    zero = torch.zeros_like(ma1)
    out = []
    for j in range(k):
        tail = zero
        if temporal is not None:
            tv, tmv = temporal
            tail = torch.where((tv & (pos_t == j))[:, None], tmv, zero)
        out.append(torch.where((p_a1 & (j == 0))[:, None], ma1,
                   torch.where((p_b1 & (pos_b1 == j))[:, None], mb1,
                   torch.where((p_b0 & (pos_b0 == j))[:, None], mb0,
                   torch.where((p_a0 & (pos_a0 == j))[:, None], ma0,
                   torch.where((p_b2 & (pos_b2 == j))[:, None], mb2, tail))))))
    return out


def amvp_cells(a_pairs, b_pairs, temporal=None):
    """AMVP (8.5.3.2.7, one reference): A = first inter of the A
    positions, B = first inter of the B positions, then the two-slot
    dedupe / zero-fill list; with `temporal` (avail, mv) the collocated
    MV fills the slots the spatial ones leave (8.5.3.2.6)."""
    va, ma = first_inter_mv(a_pairs)
    vb, mb = first_inter_mv(b_pairs)
    if temporal is not None:
        return amvp_list_t(va, ma, vb, mb, *temporal)
    return amvp_list(va, ma, vb, mb)


def arbitrate(oy_flat, log2: int, win, cand_mvs, memv, mvp0, mvp1, icost, lamf, k: int):
    """Intra / merge / AMVP arbitration at one CU size: SATD + lambda *
    bits of every merge candidate's MC (one batched MC and one SATD call
    with the ME vector's), the ME vector's with the cheaper of the two
    MVPs, and the prepass intra cost.  Returns the decision dict."""
    n = 1 << log2
    lanes = oy_flat.shape[0]
    allmv = torch.cat(list(cand_mvs) + [memv], dim=0)
    preds = mc_luma_window_batch(win.repeat(k + 1, 1, 1), allmv, n, SEARCH_RANGE)
    pflat = preds.reshape(k + 1, lanes, n * n)
    sats = ck.satd_flat(pflat.reshape((k + 1) * lanes, -1), oy_flat.repeat(k + 1, 1),
                        log2).to(torch.float32).reshape(k + 1, lanes)
    idx_bits = device_const(("merge_idx_bits", k), lambda: np.array(
        [min(j + 1, k - 1) if k > 1 else 0 for j in range(k)]), oy_flat.device, torch.float32)
    costs = fma(lamf[None, :], 2.0 + idx_bits[:, None], sats[:k])
    merge_idx = costs.argmin(dim=0)
    lane = torch.arange(lanes, device=oy_flat.device)
    cost_merge = costs[merge_idx, lane]
    merge_mv = torch.stack(cand_mvs)[merge_idx, lane]
    pred_merge = pflat[merge_idx, lane]
    mvd0, mvd1 = memv - mvp0, memv - mvp1
    bits0, bits1 = mvd_bits(mvd0), mvd_bits(mvd1)
    use_mvp1 = bits1 < bits0
    cost_me = fma(lamf, torch.minimum(bits0, bits1) + 3.0, sats[k])
    is_merge = cost_merge <= cost_me
    return dict(use_intra=icost < torch.minimum(cost_merge, cost_me), is_merge=is_merge,
                mv=torch.where(is_merge[:, None], merge_mv, memv),
                pred_inter=torch.where(is_merge[:, None], pred_merge, pflat[k]),
                merge_idx=merge_idx.to(torch.int32), mvp_flag=use_mvp1.to(torch.int32),
                mvd=torch.where(use_mvp1[:, None], mvd1, mvd0))


# ------------------------------------------------------------ host side


def walk_p_leaves(trees, width: int, ctb: int):
    """(node, x0, y0, n) for every leaf of a (nested) quad-P forest."""
    cw = width // ctb

    def rec(node, x0, y0, nn):
        if "split" in node:
            h = nn >> 1
            for (dy, dx), sub in zip(ZO, node["split"]):
                yield from rec(sub, x0 + dx * h, y0 + dy * h, h)
        else:
            yield node, x0, y0, nn

    for i, t in enumerate(trees):
        yield from rec(t, (i % cw) * ctb, (i // cw) * ctb, ctb)


def quad_p_bs_maps(trees, mv4, inter4, cbf4, width: int, height: int, ctb: int = 32):
    """Deblocking boundary strengths of a quad-P picture at 4-sample
    granularity on the 8-sample edge grid (the decoder's p/q rule; one
    reference).  CU64 inter leaves mark their four forced TU32 edges.
    Returns (bs_v (W/8 - 1, H/4), bs_h (H/8 - 1, W/4)) int32."""
    h8, w8 = height // 8, width // 8
    ev = np.zeros((h8, w8), bool)
    eh = np.zeros((h8, w8), bool)

    def mark(x0, y0, nn):
        if x0 % 8 == 0 and x0 // 8 < w8:
            ev[y0 // 8:-(-(y0 + nn) // 8), x0 // 8] = True
        if y0 % 8 == 0 and y0 // 8 < h8:
            eh[y0 // 8, x0 // 8:-(-(x0 + nn) // 8)] = True

    for node, x0, y0, nn in walk_p_leaves(trees, width, ctb):
        if nn == 64 and "ctype" in node:
            for dy, dx in ZO:
                mark(x0 + dx * 32, y0 + dy * 32, 32)
        else:
            mark(x0, y0, nn)

    intra4 = inter4 == 0
    bs_v = np.zeros((w8 - 1, 2 * h8), np.int32)
    for e in range(1, w8):
        c4 = 2 * e
        on = np.repeat(ev[:, e], 2)
        p_i, q_i = intra4[:, c4 - 1], intra4[:, c4]
        mvdiff = np.any(np.abs(mv4[:, c4 - 1] - mv4[:, c4]) >= 4, axis=-1)
        one = (cbf4[:, c4 - 1] | cbf4[:, c4] | mvdiff) > 0
        bs_v[e - 1] = np.where(on, np.where(p_i | q_i, 2, one.astype(int)), 0)
    bs_h = np.zeros((h8 - 1, 2 * w8), np.int32)
    for e in range(1, h8):
        r4 = 2 * e
        on = np.repeat(eh[e, :], 2)
        p_i, q_i = intra4[r4 - 1, :], intra4[r4, :]
        mvdiff = np.any(np.abs(mv4[r4 - 1] - mv4[r4]) >= 4, axis=-1)
        one = (cbf4[r4 - 1] | cbf4[r4] | mvdiff) > 0
        bs_h[e - 1] = np.where(on, np.where(p_i | q_i, 2, one.astype(int)), 0)
    return bs_v, bs_h


def quad_p_cell_maps(trees, width: int, height: int, ctb: int = 32):
    """(mv4, inter4, cbf4) 4x4-cell maps of the trees (the decoder's
    commit loop, for `quad_p_bs_maps`).  CU64 inter leaves set cbf per
    forced TU32."""
    h4, w4 = height // 4, width // 4
    mv4 = np.zeros((h4, w4, 2), np.int32)
    inter4 = np.zeros((h4, w4), np.int32)
    cbf4 = np.zeros((h4, w4), np.int32)
    for node, x0, y0, nn in walk_p_leaves(trees, width, ctb):
        s = slice(y0 >> 2, (y0 + nn) >> 2), slice(x0 >> 2, (x0 + nn) >> 2)
        if "ctype" not in node:
            cbf4[s] = 1 if np.any(node["lev_y"]) else 0
            continue
        inter4[s] = 1
        mv4[s] = node["mv"]
        if node["ctype"] == 3:
            continue
        if nn == 64:
            for dy, dx in ZO:
                ty = node["lev_y"][dy * 32:dy * 32 + 32, dx * 32:dx * 32 + 32]
                st = (slice((y0 + dy * 32) >> 2, (y0 + dy * 32 + 32) >> 2),
                      slice((x0 + dx * 32) >> 2, (x0 + dx * 32 + 32) >> 2))
                cbf4[st] = 1 if np.any(ty) else 0
        elif np.any(node["lev_y"]):
            cbf4[s] = 1
    return mv4, inter4, cbf4
