"""Low-delay P encode on the CTB16 grid (counterpart of
kvazzup_tpu/encoder/frame_inter.py, `encode_frame_p_fast`).

Dense pre-passes over every CTU: motion search, MC at the ME vector and
its SATD, and the intra mode/cost estimate.  The row-aligned wavefront
then resolves what depends on coded neighbours -- the merge list (up to
`merge_cand` candidates), AMVP, the intra/merge/AMVP/skip choice -- and
codes the chosen prediction.  With `tmvp` the collocated CTU's motion in
the reference picture (its centre: the CTB grid has no colBr inside the
CTB row) joins both lists as the temporal candidate.  The sequential
state is three waves of boundary samples, MVs and inter flags ("rings").

CU types per CTU: 0 = intra, 1 = merge, 2 = AMVP, 3 = skip.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ctu_kernels as ck
from ..ops import intra as intra_ops
from ..ops.costs import bits_of, fma
from ..ops.mc import (edge_pad, extract_mc_neighborhoods, mc_chroma_window_batch,
                      mc_luma_window_batch, sheared_ref_strips, strip_window_slice)
from ..ops.hopper_q import code_residual_planes
from ..ops.merge import MergeSearch
from ..ops.me import motion_search
from .frame_intra import (LAMBDA_X1K, N, P_PREPASS_MODES, _shift_lanes, from_blocks,
                          cost_prepass_grid, frame_setup, ring0, ring_boundary,
                          ring_push, wave_flags, wave_inputs, wave_to_raster)
from .wavefront import schedule_r

CT_INTRA, CT_MERGE, CT_AMVP, CT_SKIP = 0, 1, 2, 3
SEARCH_RANGE = 16
REF_PAD = SEARCH_RANGE + 8

_PREPASS_INV = np.zeros(35, np.int64)
for _k, _m in enumerate(P_PREPASS_MODES):
    _PREPASS_INV[_m] = _k


def mvd_bits(mvd):
    """(L, 2) MV differences -> (L,) float32 bit estimate."""
    return (bits_of(mvd[:, 0]) + bits_of(mvd[:, 1])) + 2.0


def first_inter_mv(cands):
    """First available (avail (L,), mv (L, 2)) pair per lane."""
    found = torch.zeros_like(cands[0][0])
    mv = torch.zeros_like(cands[0][1])
    for avail, cand in cands:
        mv = torch.where((avail & ~found)[:, None], cand, mv)
        found = found | avail
    return found, mv


def amvp_list(a_avail, a_mv, b_avail, b_mv):
    """AMVP candidates (8.5.3.2.6 without TMVP): A, then B if distinct,
    zero-filled to two."""
    both = a_avail & b_avail
    same = both & (a_mv == b_mv).all(dim=-1)
    zero = torch.zeros_like(a_mv)
    mvp0 = torch.where(a_avail[:, None], a_mv, torch.where(b_avail[:, None], b_mv, zero))
    mvp1 = torch.where((both & ~same)[:, None], b_mv, zero)
    return mvp0, mvp1


def amvp_list_t(a_avail, a_mv, b_avail, b_mv, t_avail, t_mv):
    """AMVP with the temporal candidate (8.5.3.2.6): spatial A, spatial B
    (pruned vs A), temporal when fewer than two entries, zero fill."""
    both = a_avail & b_avail
    same = both & (a_mv == b_mv).all(dim=-1)
    nspat = a_avail.to(torch.int32) + (b_avail & ~(a_avail & same)).to(torch.int32)
    zero = torch.zeros_like(a_mv)
    mvp0 = torch.where(a_avail[:, None], a_mv,
                       torch.where(b_avail[:, None], b_mv,
                                   torch.where(t_avail[:, None], t_mv, zero)))
    mvp1 = torch.where((nspat == 2)[:, None], b_mv,
                       torch.where(((nspat == 1) & t_avail)[:, None], t_mv, zero))
    return mvp0, mvp1


def _merge_candidates(k_max, v_a1, v_b1, v_b0, v_b2, mv_l, mv_a, mv_ar, mv_al,
                      temporal=None):
    """Merge list on the CTB grid (8.5.3.2.3): A1, B1 (pruned vs A1), B0
    (pruned vs B1), B2 (pruned vs A1/B1), then the temporal candidate
    when given as (avail (L,), mv (L, 2)) -- appended, never pruned --
    and zero fill."""
    def eq(a, b):
        return (a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1])

    p_a1 = v_a1
    p_b1 = v_b1 & ~(v_a1 & eq(mv_a, mv_l))
    p_b0 = v_b0 & ~(v_b1 & eq(mv_ar, mv_a))
    p_b2 = v_b2 & ~(v_a1 & eq(mv_al, mv_l)) & ~(v_b1 & eq(mv_al, mv_a))
    pos_b1 = p_a1.to(torch.int32)
    pos_b0 = pos_b1 + p_b1.to(torch.int32)
    pos_b2 = pos_b0 + p_b0.to(torch.int32)
    pos_t = pos_b2 + p_b2.to(torch.int32)
    zero = torch.zeros_like(mv_l)
    cands = []
    for k in range(k_max):
        tail = zero
        if temporal is not None:
            t_av, t_mv = temporal
            tail = torch.where((t_av & (pos_t == k))[:, None], t_mv, zero)
        mvk = torch.where((p_a1 & (k == 0))[:, None], mv_l,
              torch.where((p_b1 & (pos_b1 == k))[:, None], mv_a,
              torch.where((p_b0 & (pos_b0 == k))[:, None], mv_ar,
              torch.where((p_b2 & (pos_b2 == k))[:, None], mv_al, tail))))
        cands.append(mvk)
    return cands


def encode_frame_p_fast(y, u, v, ref_y, ref_u, ref_v, qp: int, *, width: int,
                        height: int, rdoq: bool = False, merge_cand: int = 1,
                        tmvp: bool = False, col_mv=None, col_inter=None):
    """One P frame against one (deblocked) reference picture; all planes
    uint8 tensors on one device.  With `tmvp`, col_mv (nctu, 2) and
    col_inter (nctu,) are the reference picture's motion per CTU (zeros
    when omitted).  With `rdoq` the wave quantizes by RDOQ at each lane's
    lambda^2 with its intra / inter deadzone.  Output format of the
    reference."""
    if not 1 <= merge_cand <= 5:
        raise ValueError("merge_cand must be in 1..5")
    dev = y.device
    n, m = N, N // 2
    cw, ch = width // n, height // n
    nctu = cw * ch
    sched = schedule_r(cw, ch)
    lanes = sched["lanes"]
    qp_rows, qpc_rows, lam_rows, oy, ou, ov = frame_setup(y, u, v, qp, nctu)
    if col_mv is None:
        col_mv = torch.zeros((nctu, 2), dtype=torch.int32, device=dev)
        col_inter = torch.zeros((nctu,), dtype=torch.int32, device=dev)

    # ---- dense pre-passes
    refp_y8 = edge_pad(ref_y, REF_PAD)
    refp_u8 = edge_pad(ref_u, REF_PAD // 2)
    refp_v8 = edge_pad(ref_v, REF_PAD // 2)
    me_mv, _ = motion_search(y, ref_y, int(LAMBDA_X1K[int(qp)]), block=n,
                             search_range=SEARCH_RANGE, width=width, height=height)
    win_y = extract_mc_neighborhoods(refp_y8, n, SEARCH_RANGE, cw, ch, REF_PAD)
    strips_y = sheared_ref_strips(refp_y8, n, SEARCH_RANGE, ch, REF_PAD)
    strips_u = sheared_ref_strips(refp_u8, m, SEARCH_RANGE, ch, REF_PAD // 2, chroma=True)
    strips_v = sheared_ref_strips(refp_v8, m, SEARCH_RANGE, ch, REF_PAD // 2, chroma=True)
    pred_me = mc_luma_window_batch(win_y, me_mv, n, SEARCH_RANGE).reshape(nctu, -1)
    oy_flat = oy.reshape(nctu, -1)
    satd_me = ck.satd_flat(pred_me, oy_flat, 4).to(torch.float32)
    imode, icost = cost_prepass_grid(y, oy_flat, lam_rows, log2=4, cw=cw, ch=ch)

    (oy_w, ou_w, ov_w, memv_w, pme_w, csme_w, im_w, ic_w, qp_w, qpc_w, lam_w, colmv_w,
     colok_w) = wave_inputs(sched, nctu, [
         oy_flat, ou.reshape(nctu, -1), ov.reshape(nctu, -1), me_mv, pred_me,
         satd_me, imode, icost, qp_rows, qpc_rows, lam_rows,
         col_mv.to(device=dev, dtype=torch.int32), col_inter.to(device=dev) != 0])
    fl_w, fa_w, ftr_w = wave_flags(sched, cw, dev)
    prepass_inv = torch.as_tensor(_PREPASS_INV, device=dev)

    nw = sched["n_waves"]
    outs = {
        "ctype": torch.empty((nw, lanes), dtype=torch.int32, device=dev),
        "mv": torch.empty((nw, lanes, 2), dtype=torch.int32, device=dev),
        "mvp_flag": torch.empty((nw, lanes), dtype=torch.int32, device=dev),
        "mvd": torch.empty((nw, lanes, 2), dtype=torch.int32, device=dev),
        "lev_y": torch.empty((nw, lanes, n * n), dtype=torch.int16, device=dev),
        "lev_cb": torch.empty((nw, lanes, m * m), dtype=torch.int16, device=dev),
        "lev_cr": torch.empty((nw, lanes, m * m), dtype=torch.int16, device=dev),
        "rec_y": torch.empty((nw, lanes, n * n), dtype=torch.uint8, device=dev),
        "rec_cb": torch.empty((nw, lanes, m * m), dtype=torch.uint8, device=dev),
        "rec_cr": torch.empty((nw, lanes, m * m), dtype=torch.uint8, device=dev),
    }

    ry = ring0(lanes, n, dev)
    rc = [ring0(lanes, m, dev), ring0(lanes, m, dev)]
    mv_ring = torch.zeros((3, lanes, 2), dtype=torch.int32, device=dev)
    if_ring = torch.zeros((3, lanes), dtype=torch.bool, device=dev)
    K = merge_cand
    merge = MergeSearch(strips_y, oy_w, lam_w, K, n, SEARCH_RANGE)
    outs["merge_idx"] = merge.merge_idx
    for d in range(nw):
        fl, fa, ftr = fl_w[d], fa_w[d], ftr_w[d]
        lamf = lam_w[d]
        oyw = oy_w[d]
        winc = (strip_window_slice(strips_u, d, m, SEARCH_RANGE, chroma=True),
                strip_window_slice(strips_v, d, m, SEARCH_RANGE, chroma=True))

        # neighbour MVs from the rings (lane k = CTU row k)
        mv_l, if_l = mv_ring[0], if_ring[0]
        mv_a, if_a = _shift_lanes(mv_ring[1]), _shift_lanes(if_ring[1])
        mv_ar, if_ar = _shift_lanes(mv_ring[0]), _shift_lanes(if_ring[0])
        mv_al, if_al = _shift_lanes(mv_ring[2]), _shift_lanes(if_ring[2])
        v_a1 = fl & if_l
        v_b1 = fa & if_a
        v_b0 = ftr & if_ar
        v_b2 = fl & fa & if_al
        b_avail, b_mv = first_inter_mv([(v_b0, mv_ar), (v_b1, mv_a), (v_b2, mv_al)])
        if tmvp:
            temporal = (colok_w[d], colmv_w[d])
            mvp0, mvp1 = amvp_list_t(v_a1, mv_l, b_avail, b_mv, *temporal)
        else:
            temporal = None
            mvp0, mvp1 = amvp_list(v_a1, mv_l, b_avail, b_mv)
        cands = _merge_candidates(K, v_a1, v_b1, v_b0, v_b2, mv_l, mv_a, mv_ar, mv_al,
                                  temporal)

        # every merge candidate, merge_idx bits in the cost: one launch
        _, cost_merge, merge_mv, pm_flat = merge.wave(d, cands)
        memv = memv_w[d]
        mvd0 = memv - mvp0
        mvd1 = memv - mvp1
        bits0 = mvd_bits(mvd0)
        bits1 = mvd_bits(mvd1)
        use_mvp1 = bits1 < bits0
        mvd = torch.where(use_mvp1[:, None], mvd1, mvd0)
        cost_me = fma(lamf, torch.minimum(bits0, bits1) + 3.0, csme_w[d])
        is_merge = cost_merge <= cost_me
        mv_sel = torch.where(is_merge[:, None], merge_mv, memv)
        pred_inter = torch.where(is_merge[:, None], pm_flat, pme_w[d])
        use_intra = ic_w[d] < torch.minimum(cost_merge, cost_me)

        # intra prediction at the pre-decided mode (P_PREPASS_MODES subset)
        isel = prepass_inv[im_w[d].long()]
        a_y = intra_ops.substitute_refs_ctb(ring_boundary(*ry, n), fl, fa, ftr, n)
        preds = ck.predict_modes_subset_flat(a_y, 4, True, P_PREPASS_MODES)
        pred_intra = preds.gather(1, isel[:, None, None].expand(-1, 1, n * n))[:, 0]
        pred_y = torch.where(use_intra[:, None], pred_intra, pred_inter)
        pred_c = []
        for ci in (0, 1):
            a_c = intra_ops.substitute_refs_ctb(ring_boundary(*rc[ci], m), fl, fa, ftr, m)
            preds_c = ck.predict_modes_subset_flat(a_c, 3, False, P_PREPASS_MODES)
            pred_ci = preds_c.gather(1, isel[:, None, None].expand(-1, 1, m * m))[:, 0]
            pred_cm = mc_chroma_window_batch(winc[ci], mv_sel, m, SEARCH_RANGE).reshape(lanes, -1)
            pred_c.append(torch.where(use_intra[:, None], pred_ci, pred_cm))

        # the lane's three planes share its intra/inter deadzone
        (lev_y, rec_y), *chroma = code_residual_planes(
            [(oyw, pred_y, qp_w[d], 4), (ou_w[d], pred_c[0], qpc_w[d], 3),
             (ov_w[d], pred_c[1], qpc_w[d], 3)], use_intra,
            rdoq=rdoq, lam2=lamf * lamf if rdoq else None)
        ry = ring_push(ry, rec_y, n)
        levs_c, recs_c = [lev for lev, _ in chroma], [rec for _, rec in chroma]
        rc = [ring_push(rc[ci], recs_c[ci], m) for ci in (0, 1)]

        zero_resid = ((lev_y == 0).all(dim=-1) & (levs_c[0] == 0).all(dim=-1)
                      & (levs_c[1] == 0).all(dim=-1))
        ctype = torch.where(use_intra, CT_INTRA,
                            torch.where(is_merge, torch.where(zero_resid, CT_SKIP, CT_MERGE),
                                        CT_AMVP))
        mv_ring = torch.cat([mv_sel[None], mv_ring[:2]], dim=0)
        if_ring = torch.cat([(ctype != CT_INTRA)[None], if_ring[:2]], dim=0)

        outs["ctype"][d] = ctype
        outs["mv"][d] = mv_sel
        outs["mvp_flag"][d] = use_mvp1.to(torch.int32)
        outs["mvd"][d] = mvd
        outs["lev_y"][d] = lev_y
        outs["lev_cb"][d] = levs_c[0]
        outs["lev_cr"][d] = levs_c[1]
        outs["rec_y"][d] = rec_y
        outs["rec_cb"][d] = recs_c[0]
        outs["rec_cr"][d] = recs_c[1]

    def w2r(name):
        return wave_to_raster(sched, outs[name])

    def blk(name, s):
        return w2r(name).reshape(nctu, s, s)

    return {
        "ctype": w2r("ctype"),
        "intra_mode": imode,
        "mv": w2r("mv"),
        "mvp_flag": w2r("mvp_flag"),
        "mvd": w2r("mvd"),
        "merge_idx": w2r("merge_idx"),
        "lev_y": blk("lev_y", n),
        "lev_cb": blk("lev_cb", m),
        "lev_cr": blk("lev_cr", m),
        "recon_y": from_blocks(blk("rec_y", n), height, width),
        "recon_u": from_blocks(blk("rec_cb", m), height // 2, width // 2),
        "recon_v": from_blocks(blk("rec_cr", m), height // 2, width // 2),
    }
