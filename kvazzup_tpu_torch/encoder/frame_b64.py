"""CTB64 quadtree B encode with bi-prediction, CU64 / CU32 / CU16
(counterpart of kvazzup_tpu/encoder/frame_b64.py).

The random-access engine: the CTB64 P engine (`frame_inter64`) with list 1.
Dense prepasses run a motion search per list at 64, 32 and 16, cost each
block's best of L0, L1 and BI at its ME vectors (`dense_cost`), estimate
intra at 32 and 16 from original boundaries and decide the split tree.
The row-aligned wavefront then resolves what depends on coded neighbours:
full dual-list merge lists with the spec's combined bi-predictive
candidates (8.5.3.2.4), per-list AMVP with the 8.5.3.2.9 cross-list
scaling, the intra / merge / L0 / L1 / BI choice (`arbitrate_b`) and the
reconstruction, where bi-prediction combines in the 14-bit domain
(8.5.4.2.3).

Motion state per 16x16 cell: pred flags (2,) and MVs (2, 2) [list][x, y];
an unused list's MVs are kept zero, so candidate pruning compares
(pf, mv) tuples directly.  One reference per list with distinct POCs,
2Nx2N PUs, TU == CU at depths 1..2 and the inter-only CU64 leaf with its
forced TU32s.  TMVP is off in B slices.

Batch axis: planes may carry a leading axis of B pictures of one pyramid
level (equal QP and POC distances).  The prepasses run per picture; the
62-wave loop runs once, each picture's CTB rows in their own block of
lanes (B x 17 lanes at 1080p), with every lane shift inside its block.
Every output then has the leading axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ctu_kernels as ck
from ..ops.costs import fma
from ..ops.mc import (bi_round, edge_pad, extract_mc_neighborhoods,
                      mc_chroma_window_batch_14bit, mc_luma_window_batch_14bit,
                      sheared_ref_strips, strip_window_slice, uni_round)
from ..ops.me import motion_search
from ..runtime import device_const
from .frame_b import scale_mv
from .frame_inter import CT_AMVP, CT_INTRA, CT_MERGE, CT_SKIP, REF_PAD, SEARCH_RANGE, mvd_bits
from .frame_inter32 import walk_p_leaves
from .frame_inter64 import BIG, _Wave, _mebits, wave_loop
from .frame_intra import LAMBDA_X1K, cost_prepass_grid, to_blocks, wave_inputs
from .frame_intra32 import ZO
from .frame_intra64 import (S, fetch_levels_i32, frame_rows, host, place_quadrants,
                            split_decisions, zquads)
from .wavefront import schedule_r

# 8.5.3.2.4 combined bi-predictive candidate order (l0CandIdx, l1CandIdx)
_COMB_ORDER = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
               (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


def _const(key, build, dev, dtype=torch.int64):
    return device_const(("frame_b64", key), build, dev, dtype)


def merge_list_cells_b(cands, k: int):
    """Spec B merge list (8.5.3.2.3/4/5) from per-position full-motion
    candidates: spatial A1, B1, B0, A0, B2 with full-motion pruning, the
    combined bi-predictive candidates over them in `_COMB_ORDER`, then a
    zero-MV bi-predictive fill.

    cands: dict a1, b1, b0, a0, b2 -> (avail (L,), pf (L, 2) int32,
    mv (L, 2, 2)).  With distinct L0 / L1 reference POCs a combined
    candidate is never a duplicate.  Returns (pf (k, L, 2), mv (k, L, 2,
    2)), slot-major."""
    srcs = [cands[n] for n in ("a1", "b1", "b0", "a0", "b2")]
    a1, b1, b0, a0, b2 = srcs
    (va1, _, _), (vb1, _, _), (vb0, _, _), (va0, _, _), (vb2, _, _) = srcs
    dev = va1.device

    def eq(p, q):
        return (p[1] == q[1]).all(-1) & (p[2] == q[2]).flatten(-2).all(-1)

    p_b1 = vb1 & ~(va1 & eq(b1, a1))
    p_b0 = vb0 & ~(vb1 & eq(b0, b1))
    p_a0 = va0 & ~(va1 & eq(a0, a1))
    nfirst4 = va1.int() + p_b1.int() + p_b0.int() + p_a0.int()
    p_b2 = (nfirst4 < 4) & vb2 & ~(va1 & eq(b2, a1)) & ~(vb1 & eq(b2, b1))
    p = torch.stack([va1, p_b1, p_b0, p_a0, p_b2]).to(torch.int32)  # (5, L)
    pos = torch.cumsum(p, 0) - p  # each accepted candidate's slot
    n_spat = p.sum(0)
    nbase = max(k, 4) if k > 1 else k
    ar = _const(("arange", nbase), lambda: np.arange(nbase), dev)
    onehot = ((p[:, None] != 0) & (pos[:, None] == ar[None, :, None])).to(torch.int32)
    pf_src = torch.stack([c[1] for c in srcs])  # (5, L, 2)
    mv_src = torch.stack([c[2] for c in srcs])  # (5, L, 2, 2)
    base_pf = (onehot[..., None] * pf_src[:, None]).sum(0)  # (nbase, L, 2)
    base_mv = (onehot[..., None, None] * mv_src[:, None]).sum(0)
    slot_pf, slot_mv = base_pf[:k], base_mv[:k]
    total = n_spat
    if k > 1:
        # combined candidates: the c-th is taken when both its halves exist
        # and fewer than k candidates precede it, so it lands in slot
        # n_spat + (the number of qualifying combinations before it)
        ci = _const("comb_i", lambda: np.array([i for i, _ in _COMB_ORDER]), dev)
        cj = _const("comb_j", lambda: np.array([j for _, j in _COMB_ORDER]), dev)
        cond = ((ci[:, None] < n_spat) & (cj[:, None] < n_spat)
                & (base_pf[ci][:, :, 0] != 0) & (base_pf[cj][:, :, 1] != 0)).to(torch.int32)
        slot = n_spat + torch.cumsum(cond, 0) - cond  # (12, L)
        ok = (cond != 0) & (slot < k)
        total = n_spat + ok.to(torch.int32).sum(0)
        comb_mv = torch.stack([base_mv[ci][:, :, 0], base_mv[cj][:, :, 1]], 2)  # (12, L, 2, 2)
        ks = _const(("arange", k), lambda: np.arange(k), dev)
        w = ok[:, None] & (slot[:, None] == ks[None, :, None])  # (12, k, L)
        hit = w.any(0)
        cmv = (w.to(torch.int32)[..., None, None] * comb_mv[:, None]).sum(0)
        slot_pf = torch.where(hit[..., None], 1, slot_pf)
        slot_mv = torch.where(hit[..., None, None], cmv, slot_mv)
    ks = _const(("arange", k), lambda: np.arange(k), dev)
    unfilled = total[None] <= ks[:, None]  # (k, L)
    slot_pf = torch.where(unfilled[..., None], 1, slot_pf).to(torch.int32)
    slot_mv = torch.where(unfilled[..., None, None], 0, slot_mv).to(torch.int32)
    return slot_pf, slot_mv


def amvp_cells_b(a_nbs, b_nbs, lx: int, tb: int, td_other: int):
    """Spec spatial AMVP for list lx (8.5.3.2.7, one reference per list):
    A over (A0, A1), B over (B0, B1, B2); a neighbour that uses only the
    other list gives its MV scaled by 8.5.3.2.9 (`scale_mv`); B moves to A
    when neither A neighbour is coded inter.

    a_nbs / b_nbs: [(avail (L,), pf (L, 2), mv (L, 2, 2))]; tb = poc_cur -
    poc_ref[lx], td_other = poc_cur - poc_ref[1 - lx], both clipped to
    [-128, 127].  Returns (mvp0, mvp1), each (L, 2)."""
    ly = 1 - lx
    fls = torch.zeros_like(a_nbs[0][0])
    zmv = torch.zeros_like(a_nbs[0][2][:, 0])

    def first_noscale(nbs):
        avail, mvo = fls, zmv
        for av, pf, mv in nbs:
            c = av & (pf[:, lx] != 0)
            mvo = torch.where((c & ~avail)[:, None], mv[:, lx], mvo)
            avail = avail | c
        return avail, mvo

    def first_scaled(nbs):
        scaled = scale_mv(torch.stack([mv[:, ly] for _, _, mv in nbs]), tb, td_other)
        avail, mvo = fls, zmv
        for (av, pf, mv), sc in zip(nbs, scaled):
            inter = av & ((pf[:, 0] | pf[:, 1]) != 0)
            cand = torch.where((pf[:, lx] != 0)[:, None], mv[:, lx], sc)
            mvo = torch.where((inter & ~avail)[:, None], cand, mvo)
            avail = avail | inter
        return avail, mvo

    a_ns, a_mv_ns = first_noscale(a_nbs)
    a_sc, a_mv_sc = first_scaled(a_nbs)
    avail_a = a_ns | a_sc
    mv_a = torch.where(a_ns[:, None], a_mv_ns, a_mv_sc)
    is_scaled = fls
    for av, pf, _ in a_nbs:
        is_scaled = is_scaled | (av & ((pf[:, 0] | pf[:, 1]) != 0))
    b_ns, b_mv_ns = first_noscale(b_nbs)
    b_sc, b_mv_sc = first_scaled(b_nbs)
    fa_av = torch.where(is_scaled, avail_a, b_ns)
    fa_mv = torch.where(is_scaled[:, None], mv_a, b_mv_ns)
    fb_av = torch.where(is_scaled, b_ns, b_sc)
    fb_mv = torch.where(is_scaled[:, None], b_mv_ns, b_mv_sc)
    both = fa_av & fb_av
    same = both & (fa_mv == fb_mv).all(-1)
    mvp0 = torch.where(fa_av[:, None], fa_mv, torch.where(fb_av[:, None], fb_mv, zmv))
    mvp1 = torch.where((both & ~same)[:, None], fb_mv, zmv)
    return mvp0, mvp1


def combine(p0, p1, pf):
    """The prediction of (L, ...) 14-bit list predictions p0, p1 under pred
    flags pf (L, 2): bi_round where both lists are used, else the used
    list's uni_round."""
    shape = (-1,) + (1,) * (p0.ndim - 1)
    both = ((pf[:, 0] & pf[:, 1]) != 0).reshape(shape)
    use0 = (pf[:, 0] != 0).reshape(shape)
    return torch.where(both, bi_round(p0, p1), torch.where(use0, uni_round(p0), uni_round(p1)))


def arbitrate_b(oy_flat, log2: int, win0, win1, merge_cands, me0, me1, mvp_l0, mvp_l1, icost,
                lamf, k: int):
    """B-slice intra / merge / L0 / L1 / BI arbitration at one CU size.

    One batched MC over [k merge + the ME vector] x [L0, L1] and one
    batched SATD over [k merge, L0, L1, BI]; costs are SATD + lambda *
    bits as fused multiply-adds.  merge_cands: (pf (k, L, 2), mv (k, L, 2,
    2)).  Returns the decisions with full dual-list motion (an unused
    list's MVs zero)."""
    n = 1 << log2
    lanes = oy_flat.shape[0]
    pf_all, mv_all = merge_cands
    allmv = torch.cat([mv_all[:, :, 0].reshape(-1, 2), me0, mv_all[:, :, 1].reshape(-1, 2), me1])
    winb = torch.cat([win0.repeat(k + 1, 1, 1), win1.repeat(k + 1, 1, 1)])
    p14 = mc_luma_window_batch_14bit(winb, allmv, n, SEARCH_RANGE).reshape(2, k + 1, lanes, n, n)
    p0s, p1s = p14[0], p14[1]
    both_m = ((pf_all[:, :, 0] & pf_all[:, :, 1]) != 0)[:, :, None, None]
    use0_m = (pf_all[:, :, 0] != 0)[:, :, None, None]
    pred_m = torch.where(both_m, bi_round(p0s[:k], p1s[:k]),
                         torch.where(use0_m, uni_round(p0s[:k]), uni_round(p1s[:k])))
    p0u = uni_round(p0s[k]).reshape(lanes, -1)
    p1u = uni_round(p1s[k]).reshape(lanes, -1)
    pbi = bi_round(p0s[k], p1s[k]).reshape(lanes, -1)
    preds_all = torch.cat([pred_m.reshape(k * lanes, -1), p0u, p1u, pbi])
    sats = ck.satd_flat(preds_all, oy_flat.repeat(k + 3, 1), log2).to(torch.float32).reshape(
        k + 3, lanes)
    idx_bits = device_const(("merge_idx_bits", k), lambda: np.array(
        [min(j + 1, k - 1) if k > 1 else 0 for j in range(k)]), oy_flat.device, torch.float32)
    costs_s = fma(lamf[None, :], 2.0 + idx_bits[:, None], sats[:k])
    merge_idx = costs_s.argmin(dim=0)
    lane = torch.arange(lanes, device=oy_flat.device)
    cost_merge = costs_s[merge_idx, lane]
    merge_pf = pf_all[merge_idx, lane]
    merge_mv = mv_all[merge_idx, lane]
    pred_mrg = pred_m.reshape(k, lanes, -1)[merge_idx, lane]

    def mvd_cost(me, mvp):
        d0, d1 = me - mvp[0], me - mvp[1]
        b0, b1 = mvd_bits(d0), mvd_bits(d1)
        use1 = b1 < b0
        return torch.minimum(b0, b1), use1.to(torch.int32), torch.where(use1[:, None], d1, d0)

    bits0, flag0, mvd0 = mvd_cost(me0, mvp_l0)
    bits1, flag1, mvd1 = mvd_cost(me1, mvp_l1)
    cost_l0 = fma(lamf, bits0 + 5.0, sats[k])
    cost_l1 = fma(lamf, bits1 + 5.0, sats[k + 1])
    cost_bi = fma(lamf, bits0 + bits1 + 7.0, sats[k + 2])
    expl = torch.stack([cost_l0, cost_l1, cost_bi], 1)
    kind = expl.argmin(dim=1)  # 0 L0, 1 L1, 2 BI
    cost_expl = expl.min(dim=1).values
    inter_dir = torch.where(kind == 2, 3, kind + 1).to(torch.int32)
    pf_expl = torch.stack([(kind == 0) | (kind == 2), (kind == 1) | (kind == 2)],
                          1).to(torch.int32)
    mv_expl = torch.stack([me0, me1], 1) * pf_expl[:, :, None]
    mvd_expl = torch.stack([mvd0, mvd1], 1) * pf_expl[:, :, None]
    flag_expl = torch.stack([flag0, flag1], 1) * pf_expl
    pred_expl = torch.where((kind == 0)[:, None], p0u, torch.where((kind == 1)[:, None], p1u, pbi))
    is_merge = cost_merge <= cost_expl
    use_intra = icost < torch.minimum(cost_merge, cost_expl)
    return dict(use_intra=use_intra, is_merge=is_merge,
                pf=torch.where(is_merge[:, None], merge_pf, pf_expl),
                mv=torch.where(is_merge[:, None, None], merge_mv * merge_pf[:, :, None], mv_expl),
                pred_inter=torch.where(is_merge[:, None], pred_mrg, pred_expl),
                merge_idx=merge_idx.to(torch.int32), inter_dir=inter_dir, mvp_flag=flag_expl,
                mvd=mvd_expl)


class _WaveB(_Wave):
    """The B wave: motion cells of (pred flags (L, 2), mv (L, 2, 2)), two
    reference lists (wins: per list the luma, Cb and Cr windows)."""

    def __init__(self, *args, tb):
        super().__init__(*args)
        self.tb = tb  # (poc_cur - poc_ref0, poc_cur - poc_ref1), clipped

    MOTION = ((2,), (2, 2))

    @staticmethod
    def inter(first):
        return (first[:, 0] | first[:, 1]) != 0

    def unit_lists(self, mot, x0: int, y0: int, n: int, temporal=None):
        a1, b1, b0, a0, b2 = ((av, *m) for av, m in self.neighbours(mot, x0, y0, n))
        merge = merge_list_cells_b({"a1": a1, "b1": b1, "b0": b0, "a0": a0, "b2": b2}, self.k)
        a_nbs, b_nbs = [a0, a1], [b0, b1, b2]
        tb0, tb1 = self.tb
        return (merge, amvp_cells_b(a_nbs, b_nbs, 0, tb0, tb1),
                amvp_cells_b(a_nbs, b_nbs, 1, tb1, tb0))

    def chroma_pred(self, mv, pf, xc: int, yc: int, m: int):
        """Dual-list chroma MC and combine at (xc, yc, m): one batched MC
        over [Cb L0, Cr L0, Cb L1, Cr L1].  Returns (2, L, m, m), Cb then
        Cr."""
        lanes = self.lanes
        winb = torch.cat([self.unit_window(w, xc, yc, m, True)
                          for li in (0, 1) for w in self.wins[li][1:]])
        mvb = torch.cat([mv[:, 0].repeat(2, 1), mv[:, 1].repeat(2, 1)])
        c = mc_chroma_window_batch_14bit(winb, mvb, m, SEARCH_RANGE)
        return combine(c[:2 * lanes], c[2 * lanes:], pf.repeat(2, 1)).reshape(2, lanes, m, m)

    def code_unit(self, canvases, mot, x0: int, y0: int, log2: int, imode, icost, me0, me1):
        lanes, n = self.lanes, 1 << log2
        merge, mvp_l0, mvp_l1 = self.unit_lists(mot, x0, y0, n)
        arb = arbitrate_b(self.orig_flat(x0, y0, n), log2,
                          self.unit_window(self.wins[0][0], x0, y0, n),
                          self.unit_window(self.wins[1][0], x0, y0, n), merge, me0, me1,
                          mvp_l0, mvp_l1, icost, self.lamf, self.k)
        m = n >> 1
        pred_c = self.chroma_pred(arb["mv"], arb["pf"], x0 >> 1, y0 >> 1, m)
        levs, ct = self.code_planes(canvases, x0, y0, log2, arb, imode,
                                    pred_c.reshape(2, lanes, m * m))
        pf_st = arb["pf"] * (ct != CT_INTRA).to(torch.int32)[:, None]
        cs = (slice(None), slice(y0 >> 4, (y0 + n) >> 4), slice(x0 >> 4, (x0 + n) >> 4))
        mot[0][cs] = pf_st[:, None, None]
        mot[1][cs] = (arb["mv"] * pf_st[:, :, None])[:, None, None]
        return dict(ct=ct, pf=arb["pf"], dir=arb["inter_dir"], mv=arb["mv"],
                    merge_idx=arb["merge_idx"], mvp_flag=arb["mvp_flag"], mvd=arb["mvd"],
                    lev=levs)


def _prepass(y, u, v, refs, qp: int, width: int, height: int):
    """One picture's dense prepasses: per-CTB originals, ME vectors per list
    at 64 / 32 / 16 (z-ordered), intra modes and costs at 32 / 16, split
    flags; and the per-list sheared reference strips of the wave loop."""
    dev = y.device
    cw, ch = width // S, height // S
    nctb = cw * ch
    qp_rows, qpc_rows, lam_rows = frame_rows(qp, nctb, dev)
    _, _, lam32 = frame_rows(qp, 4 * nctb, dev)
    _, _, lam16 = frame_rows(qp, 16 * nctb, dev)
    yi = y.to(torch.int32)
    orig = {64: to_blocks(yi, S).reshape(nctb, -1), 32: to_blocks(yi, 32).reshape(-1, 1024),
            16: to_blocks(yi, 16).reshape(-1, 256)}
    lam_b = {64: lam_rows, 32: lam32, 16: lam16}
    lam_x1k = int(LAMBDA_X1K[int(qp)])  # lambda is one value a frame, so its mean is it
    me, strips = {}, {}
    p14 = {}
    for li, (ry, ru, rv) in enumerate(refs):
        for b in (64, 32, 16):
            me[li, b] = motion_search(y, ry, lam_x1k, block=b, search_range=SEARCH_RANGE,
                                      width=width, height=height)[0]
        refp = (edge_pad(ry, REF_PAD), edge_pad(ru, REF_PAD // 2), edge_pad(rv, REF_PAD // 2))
        for b in (64, 32, 16):
            f = S // b
            wins = extract_mc_neighborhoods(refp[0], b, SEARCH_RANGE, f * cw, f * ch, REF_PAD)
            p14[li, b] = mc_luma_window_batch_14bit(wins, me[li, b], b, SEARCH_RANGE)
            del wins
        strips[li] = (sheared_ref_strips(refp[0], S, SEARCH_RANGE, ch, REF_PAD),
                      *(sheared_ref_strips(r, S // 2, SEARCH_RANGE, ch, REF_PAD // 2, chroma=True)
                        for r in refp[1:]))

    def dense_cost(b):
        """min over L0 / L1 / BI of the rate-biased SATD at block size b."""
        log2 = b.bit_length() - 1
        rows = orig[b].shape[0]
        p0, p1 = p14[0, b], p14[1, b]
        b0, b1 = _mebits(me[0, b]), _mebits(me[1, b])
        sat = [ck.satd_flat(p.reshape(rows, -1), orig[b], log2).to(torch.float32)
               for p in (uni_round(p0), uni_round(p1), bi_round(p0, p1))]
        lam = lam_b[b]
        c0 = fma(lam, b0 + 5.0, sat[0])
        c1 = fma(lam, b1 + 5.0, sat[1])
        cb = fma(lam, b0 + b1 + 7.0, sat[2])
        return torch.minimum(torch.minimum(c0, c1), cb)

    imode16, icost16 = cost_prepass_grid(yi, orig[16], lam16, log2=4, cw=4 * cw, ch=4 * ch)
    imode32, icost32 = cost_prepass_grid(yi, orig[32], lam32, log2=5, cw=2 * cw, ch=2 * ch)
    cost64 = dense_cost(64)
    best32 = torch.minimum(icost32, dense_cost(32))
    best16 = torch.minimum(icost16, dense_cost(16))
    del p14
    split64, split32 = split_decisions(best16, best32, cost64, lam32, lam_rows, cw, ch)

    def z32(a):
        return zquads(a, 2 * cw, 2 * ch)

    def z16(a):
        return zquads(zquads(a, 4 * cw, 4 * ch), 2 * cw, 2 * ch)

    per_ctb = [orig[64].reshape(nctb, S, S), to_blocks(u.to(torch.int32), S // 2),
               to_blocks(v.to(torch.int32), S // 2), me[0, 64], me[1, 64], z32(me[0, 32]),
               z32(me[1, 32]), z16(me[0, 16]), z16(me[1, 16]), z32(imode32), z32(icost32),
               z16(imode16), z16(icost16), split64, split32, qp_rows, qpc_rows, lam_rows]
    return per_ctb, strips, (split64, split32, z32(imode32), z16(imode16))


def encode_frame_b64_fast(y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, qp: int, poc_diffs, *,
                          width: int, height: int, merge_cand: int = 1, rdoq: bool = False):
    """CTB64 B frame(s) against two (loop-filtered) reference pictures;
    all planes uint8 tensors on one device, each (H, W) or with a leading
    batch axis of B pictures that share qp and poc_diffs.  poc_diffs:
    (poc_cur - poc_ref0, poc_cur - poc_ref1), for the AMVP cross-list
    scaling.  With `rdoq` every unit and the CU64 leaf quantize by RDOQ at
    the lane's lambda^2 (the prepasses keep the deadzone quantizer).
    Returns the decision bundle of the reference (with the batch axis when
    given one) for `quad_b64_trees_from_device`."""
    if not 1 <= merge_cand <= 5:
        raise ValueError("merge_cand must be in 1..5")
    planes = [y, u, v, r0y, r0u, r0v, r1y, r1u, r1v]
    batched = y.ndim == 3
    if not batched:
        planes = [p[None] for p in planes]
    nb = planes[0].shape[0]
    dev = y.device
    cw, ch = width // S, height // S
    nctb = cw * ch
    k = merge_cand
    qp = int(qp)
    tb = tuple(min(max(int(t), -128), 127) for t in poc_diffs)
    sched = schedule_r(cw, ch)
    lanes = nb * sched["lanes"]

    # ---- dense prepasses, picture by picture
    per_ctb, strips, dec = [], [], []
    for b in range(nb):
        yb, ub, vb, r0 = planes[0][b], planes[1][b], planes[2][b], [p[b] for p in planes[3:6]]
        r1 = [p[b] for p in planes[6:9]]
        arrays, st, dc = _prepass(yb, ub, vb, (r0, r1), qp, width, height)
        per_ctb.append(arrays)
        strips.append(st)
        dec.append(dc)
    arrays = [torch.cat(a) for a in zip(*per_ctb)]
    strips = [[torch.cat([st[li][p] for st in strips]) for p in range(3)] for li in (0, 1)]
    del per_ctb

    # ---- wave
    (oy_w, ou_w, ov_w, me64_0w, me64_1w, me32_0w, me32_1w, me16_0w, me16_1w, im32_w, ic32_w,
     im16_w, ic16_w, s64_w, s32_w, qp_w, qpc_w, lam_w) = wave_inputs(sched, nctb, arrays, nb)
    del arrays
    m = S // 2
    big = torch.full((lanes,), BIG, dtype=torch.float32, device=dev)

    def make_wave(d, views, flags, cells):
        wins = [(strip_window_slice(st[0], d, S, SEARCH_RANGE),
                 strip_window_slice(st[1], d, m, SEARCH_RANGE, chroma=True),
                 strip_window_slice(st[2], d, m, SEARCH_RANGE, chroma=True)) for st in strips]
        return _WaveB(lanes, dev, k, views, (oy_w[d], ou_w[d], ov_w[d]),
                      (qp_w[d], qpc_w[d], qpc_w[d]), lam_w[d], flags, cells, wins, rdoq, tb=tb)

    def unit_args(d, q32, q16):
        if q16 is None:
            return im32_w[d][:, q32], ic32_w[d][:, q32], me32_0w[d][:, q32], me32_1w[d][:, q32]
        return (im16_w[d][:, q32, q16], ic16_w[d][:, q32, q16], me16_0w[d][:, q32, q16],
                me16_1w[d][:, q32, q16])

    def leaf64(wv, d):
        """CU64 leaf: inter only (merge / L0 / L1 / BI), MC of the whole
        64x64 once per list, four forced TU32s (chroma TU16s)."""
        wins = wv.wins
        merge64, mvp0_64, mvp1_64 = wv.unit_lists(wv.motion_grids(), 0, 0, 64)
        arb64 = arbitrate_b(oy_w[d].reshape(lanes, -1), 6, wins[0][0], wins[1][0], merge64,
                            me64_0w[d], me64_1w[d], mvp0_64, mvp1_64, big, lam_w[d], k)
        p64 = mc_luma_window_batch_14bit(torch.cat([wins[0][0], wins[1][0]]),
                                         torch.cat([arb64["mv"][:, 0], arb64["mv"][:, 1]]), S,
                                         SEARCH_RANGE)
        pred64 = combine(p64[:lanes], p64[lanes:], arb64["pf"])
        pc64 = wv.chroma_pred(arb64["mv"], arb64["pf"], 0, 0, m).reshape(2 * lanes, m, m)
        lev64, rec64, zero64 = wv.code_cu64(pred64, pc64)
        ct64 = torch.where(arb64["is_merge"], torch.where(zero64, CT_SKIP, CT_MERGE),
                           CT_AMVP).to(torch.int32)
        pf64 = arb64["pf"]
        mv64 = arb64["mv"] * pf64[:, :, None]
        dec = {"ct64": ct64, "pf64": pf64, "dir64": arb64["inter_dir"], "mv64": mv64,
               "merge_idx64": arb64["merge_idx"], "mvp_flag64": arb64["mvp_flag"],
               "mvd64": arb64["mvd"]}
        return dec, lev64, rec64, (pf64, mv64)

    res = wave_loop(sched, nb, width, height, dev, _WaveB.MOTION, (s64_w, s32_w), make_wave,
                    unit_args, leaf64)
    for key, i in (("split64", 0), ("split32", 1), ("imode32", 2), ("imode16", 3)):
        res[key] = torch.stack([dc[i] for dc in dec])
    if not batched:
        res = {key: val[0] for key, val in res.items()}
    return res


# ------------------------------------------------------------ host side


def quad_b64_trees_from_device(out, width: int, height: int):
    """Nested cu32-format trees (size 64) from the CTB64 B outputs of one
    picture.  Inter leaves carry full dual-list motion: ctype, pf (2,),
    inter_dir, mv (2, 2), merge_idx, mvp_flag (2,), mvd (2, 2)."""
    nctb = (width // 64) * (height // 64)
    s64 = host(out["split64"]).reshape(-1)
    s32 = host(out["split32"]).reshape(nctb, 4)
    keys = ("imode32", "imode16", "ct64", "pf64", "dir64", "mv64", "merge_idx64", "mvp_flag64",
            "mvd64", "ct32", "pf32", "dir32", "mv32", "merge_idx32", "mvp_flag32", "mvd32",
            "ct16", "pf16", "dir16", "mv16", "merge_idx16", "mvp_flag16", "mvd16")
    d = {k: host(out[k]) for k in keys}
    lev_y, lev_cb, lev_cr = fetch_levels_i32(out)
    lev_y = lev_y.reshape(nctb, 4, 1024)
    lev_cb = lev_cb.reshape(nctb, 4, 256)
    lev_cr = lev_cr.reshape(nctb, 4, 256)

    def leaf(sz, ct, mode, pf, dr, mv, mi, mf, mvd, ly, lb, lr):
        if ct == CT_INTRA:
            return dict(size=sz, part=0, modes=[int(mode)], lev_y=ly, lev_cb=lb, lev_cr=lr)
        return dict(size=sz, ctype=int(ct), pf=(int(pf[0]), int(pf[1])), inter_dir=int(dr),
                    mv=tuple(tuple(int(x) for x in mv[li]) for li in range(2)),
                    merge_idx=int(mi), mvp_flag=(int(mf[0]), int(mf[1])),
                    mvd=tuple(tuple(int(x) for x in mvd[li]) for li in range(2)),
                    lev_y=ly, lev_cb=lb, lev_cr=lr)

    def unit(sz, idx, mode):
        """A leaf's ct, intra mode and motion fields, for `leaf`."""
        return [d[f"ct{sz}"][idx], mode] + [d[f"{key}{sz}"][idx] for key in
                                           ("pf", "dir", "mv", "merge_idx", "mvp_flag", "mvd")]

    trees = []
    for i in range(nctb):
        if not s64[i]:
            trees.append(leaf(64, *unit(64, i, 0),
                              *place_quadrants(lev_y[i], lev_cb[i], lev_cr[i])))
            continue
        sub32 = []
        for q in range(4):
            if s32[i, q]:
                ly = lev_y[i, q].reshape(4, 16, 16)
                lb = lev_cb[i, q].reshape(4, 8, 8)
                lr = lev_cr[i, q].reshape(4, 8, 8)
                sub32.append(dict(size=32, split=[
                    leaf(16, *unit(16, (i, q, z), d["imode16"][i, q, z]), ly[z], lb[z], lr[z])
                    for z in range(4)]))
            else:
                sub32.append(leaf(32, *unit(32, (i, q), d["imode32"][i, q]),
                                  lev_y[i, q].reshape(32, 32), lev_cb[i, q].reshape(16, 16),
                                  lev_cr[i, q].reshape(16, 16)))
        trees.append(dict(size=64, split=sub32))
    return trees


def quad_b_cell_maps(trees, width: int, height: int, ctb: int = 64):
    """(mv4 (h4, w4, 2, 2), pf4 (h4, w4, 2), cbf4) 4x4-cell maps of B trees
    (the decoder's commit loop, for `quad_b_bs_maps`)."""
    h4, w4 = height // 4, width // 4
    mv4 = np.zeros((h4, w4, 2, 2), np.int32)
    pf4 = np.zeros((h4, w4, 2), np.int32)
    cbf4 = np.zeros((h4, w4), np.int32)
    for node, x0, y0, nn in walk_p_leaves(trees, width, ctb):
        s = slice(y0 >> 2, (y0 + nn) >> 2), slice(x0 >> 2, (x0 + nn) >> 2)
        if "ctype" not in node:
            cbf4[s] = 1 if np.any(node["lev_y"]) else 0
            continue
        pf4[s] = node["pf"]
        mv4[s] = node["mv"]
        if node["ctype"] == CT_SKIP:
            continue
        if nn == 64:
            for dy, dx in ZO:
                ty = node["lev_y"][dy * 32:dy * 32 + 32, dx * 32:dx * 32 + 32]
                st = (slice((y0 + dy * 32) >> 2, (y0 + dy * 32 + 32) >> 2),
                      slice((x0 + dx * 32) >> 2, (x0 + dx * 32 + 32) >> 2))
                cbf4[st] = 1 if np.any(ty) else 0
        elif np.any(node["lev_y"]):
            cbf4[s] = 1
    return mv4, pf4, cbf4


def quad_b_bs_maps(trees, mv4, pf4, cbf4, width: int, height: int, ctb: int = 64):
    """Deblocking boundary strengths of a quad-B picture (8.7.2.4 with two
    lists) at 4-sample granularity on the 8-sample edge grid: differing
    pred-flag patterns give bS 1, else a used list's |MV difference| >= 4
    does.  Returns (bs_v (W/8 - 1, H/4), bs_h (H/8 - 1, W/4)) int32."""
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

    intra4 = (pf4[..., 0] | pf4[..., 1]) == 0

    def edge_bs(p4, q4):
        pa, pb = pf4[p4], pf4[q4]
        ma, mb = mv4[p4], mv4[q4]
        diff_refs = np.any(pa != pb, axis=-1)
        mv_edge = np.any((np.abs(ma - mb) >= 4) & (pa[..., None] != 0), axis=(-2, -1))
        one = diff_refs | (cbf4[p4] != 0) | (cbf4[q4] != 0) | mv_edge
        return intra4[p4], intra4[q4], one

    bs_v = np.zeros((w8 - 1, 2 * h8), np.int32)
    for e in range(1, w8):
        c4 = 2 * e
        on = np.repeat(ev[:, e], 2)
        p_i, q_i, one = edge_bs((slice(None), c4 - 1), (slice(None), c4))
        bs_v[e - 1] = np.where(on, np.where(p_i | q_i, 2, one.astype(int)), 0)
    bs_h = np.zeros((h8 - 1, 2 * w8), np.int32)
    for e in range(1, h8):
        r4 = 2 * e
        on = np.repeat(eh[e, :], 2)
        p_i, q_i, one = edge_bs((r4 - 1, slice(None)), (r4, slice(None)))
        bs_h[e - 1] = np.where(on, np.where(p_i | q_i, 2, one.astype(int)), 0)
    return bs_v, bs_h
