"""CTB64 quadtree low-delay P encode, CU64 / CU32 / CU16 (counterpart of
kvazzup_tpu/encoder/frame_inter64.py without RDOQ or motion-constrained
tiles).

Dense prepasses decide the split tree: motion searches at 64, 32 and 16,
the MC and SATD of each ME vector, and orig-boundary intra estimates at
32 and 16 (`frame_intra.cost_prepass_grid`).  The row-aligned wavefront
over the 64-grid then resolves what depends on coded neighbours: the merge
and AMVP lists at 16x16 motion-cell granularity (a static z-scan cell
resolver over the wave's cells and three waves of CTB-edge cells), the
intra / merge / AMVP / skip choice (`frame_inter32.arbitrate`) and the
reconstruction on per-lane canvases (the `frame_intra64` walk machinery).
The CU64 leaf is inter only (2Nx2N merge / AMVP / skip, four forced
TU32s); intra competes at the 32 and 16 leaves.  With TMVP (8.5.3.2.8)
the temporal candidate of each of a CTB's 21 units is found before the
wave (`temporal_cells`) from the reference picture's motion store on the
16x16 grid.

CU types: 0 intra, 1 merge, 2 AMVP, 3 skip.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ctu_kernels as ck
from ..ops.costs import bits_of, fma
from ..ops.hopper_q import code_residual_planes, code_residual_rows
from ..ops.mc import (edge_pad, extract_mc_neighborhoods, mc_chroma_window_batch,
                      mc_luma_window_batch, sheared_ref_strips, strip_window_slice)
from ..ops.me import motion_search
from ..runtime import device_const
from .frame_inter import (CT_AMVP, CT_INTRA, CT_MERGE, CT_SKIP, REF_PAD, SEARCH_RANGE,
                          _PREPASS_INV)
from .frame_inter32 import amvp_cells, arbitrate, merge_list_cells
from .frame_intra import (LAMBDA_X1K, P_PREPASS_MODES, cost_prepass_grid, from_blocks,
                          ring0, ring_push, to_blocks, wave_flags, wave_inputs, wave_to_raster)
from .frame_intra32 import ZO
from .frame_intra64 import (S, frame_rows, host, fetch_levels_i32, place_quadrants,
                            ring_views, seg_spec, split_decisions, unit_walk, zquads, zscan)
from .wavefront import schedule_r

BIG = 1e30  # the CU64 leaf's intra cost: never chosen


def _quads(a, h: int):
    """(B, 2h, 2h) -> (4B, h, h), z-order quadrant major."""
    return torch.cat([a[:, dy * h:dy * h + h, dx * h:dx * h + h] for dy, dx in ZO], dim=0)


def _mebits(mv):
    return bits_of(mv[:, 0]) + bits_of(mv[:, 1])


def temporal_cells(col_mv, col_inter, cw: int, ch: int):
    """Per-unit temporal candidate (mv, ok) for the 21 units of each CTB,
    from the raster 16-grid collocated store col_mv (16 cw ch, 2), col_inter
    (16 cw ch,): colBr when it lies in the picture and in the unit's CTB
    row (it may be in the CTB to the right) and is inter, else colCtr.
    Returns t64 ((nctb, 2), (nctb,)), t32 ((nctb, 4, 2), (nctb, 4)) and
    t16 ((nctb, 4, 4, 2), (nctb, 4, 4)), ok as int32."""
    h16, w16 = 4 * ch, 4 * cw
    nctb = cw * ch
    dev = col_mv.device
    cmv = col_mv.to(torch.int32).reshape(h16, w16, 2)
    cif = col_inter.to(torch.int32).reshape(h16, w16)
    ys0 = 4 * np.arange(ch)[:, None]
    xs0 = 4 * np.arange(cw)[None, :]

    def cell(cy: int, cx: int):
        """The collocated cell at (cy, cx) of every CTB's 4x4 cell grid
        (cx == 4 is the CTB to the right); unavailable outside the
        picture."""
        ys, xs = np.broadcast_arrays(ys0 + cy, xs0 + cx)
        valid = torch.as_tensor(((ys < h16) & (xs < w16)).reshape(-1), device=dev)
        ysc = torch.as_tensor(np.minimum(ys, h16 - 1).reshape(-1), device=dev)
        xsc = torch.as_tensor(np.minimum(xs, w16 - 1).reshape(-1), device=dev)
        ok = torch.where(valid, cif[ysc, xsc], 0)
        return cmv[ysc, xsc], ok != 0

    def unit_t(x0: int, y0: int, n: int):
        ctr_mv, ctr_ok = cell((y0 + n // 2) >> 4, (x0 + n // 2) >> 4)
        if y0 + n >= 64:  # colBr in the next CTB row: unavailable
            return ctr_mv, ctr_ok
        br_mv, br_ok = cell((y0 + n) >> 4, (x0 + n) >> 4)
        return torch.where(br_ok[:, None], br_mv, ctr_mv), br_ok | ctr_ok

    def stack(units):  # [(mv, ok)] -> (mv, ok int32), unit axis 1
        return (torch.stack([m for m, _ in units], 1),
                torch.stack([o for _, o in units], 1).to(torch.int32))

    t64m, t64o = unit_t(0, 0, 64)
    t32 = stack([unit_t(dx3 * 32, dy3 * 32, 32) for dy3, dx3 in ZO])
    t16 = [stack([unit_t(dx3 * 32 + dx * 16, dy3 * 32 + dy * 16, 16) for dy, dx in ZO])
           for dy3, dx3 in ZO]
    return (t64m, t64o.to(torch.int32), *t32,
            torch.stack([m for m, _ in t16], 1), torch.stack([o for _, o in t16], 1))


class _Wave:
    """One wave's state and per-unit coding (the reference's wave body)."""

    def __init__(self, lanes, dev, k, views, origs, qps, lamf, flags, cells, wins, rdoq):
        self.lanes, self.dev, self.k = lanes, dev, k
        self.views, self.origs, self.qps, self.lamf = views, origs, qps, lamf
        self.lam2 = lamf * lamf if rdoq else None  # RDOQ's lambda^2 per lane
        self.rdoq = rdoq
        self.flags = flags
        self.cells = cells  # CTB-edge motion cells from the rings
        self.win64, self.winu, self.winv = wins
        self.zmv = torch.zeros((lanes, 2), dtype=torch.int32, device=dev)
        self.no = torch.zeros((lanes,), dtype=torch.bool, device=dev)

    def mcell(self, mcv, mif, x: int, y: int, zcur: int):
        """(avail (L,), mv (L, 2)) of the motion cell holding pixel (x, y),
        with z-scan availability (6.4.1)."""
        fl, fa, ftr, fal = (self.flags[f] for f in ("fl", "fa", "ftr", "fal"))
        c = self.cells
        if y >= 64 or (x >= 64 and y >= 0):
            return self.no, self.zmv
        if x < 0 and y < 0:
            return fal & (c["AL_if"] != 0), c["AL_mv"]
        if x < 0:
            return fl & (c["L_if"][:, y >> 4] != 0), c["L_mv"][:, y >> 4]
        if y < 0:
            if x < 64:
                return fa & (c["T_if"][:, x >> 4] != 0), c["T_mv"][:, x >> 4]
            return ftr & (c["TR_if"][:, (x - 64) >> 4] != 0), c["TR_mv"][:, (x - 64) >> 4]
        if zscan(x, y) < zcur:
            return mif[:, y >> 4, x >> 4] != 0, mcv[:, y >> 4, x >> 4]
        return self.no, self.zmv

    def unit_lists(self, mcv, mif, x0: int, y0: int, n: int, temporal=None):
        zcur = zscan(x0, y0)

        def mc(x, y):
            return self.mcell(mcv, mif, x, y, zcur)

        a1, b1, b0 = mc(x0 - 1, y0 + n - 1), mc(x0 + n - 1, y0 - 1), mc(x0 + n, y0 - 1)
        a0, b2 = mc(x0 - 1, y0 + n), mc(x0 - 1, y0 - 1)
        merge = merge_list_cells({"a1": a1, "b1": b1, "b0": b0, "a0": a0, "b2": b2}, self.k,
                                 temporal)
        return (merge, *amvp_cells([a0, a1], [b0, b1, b2], temporal))

    def intra_pred(self, canvas, p: int, x0: int, y0: int, log2: int, sel):
        n = 1 << log2
        a = unit_walk(canvas, self.views[p], seg_spec(x0, y0, n, S >> (p > 0)), n, self.flags)
        preds = ck.predict_modes_subset_flat(a, log2, p == 0, P_PREPASS_MODES)
        return preds.gather(1, sel[:, None, None].expand(-1, 1, n * n))[:, 0]

    def code_unit(self, canvases, mcv, mif, x0: int, y0: int, log2: int, imode, icost, memv,
                  temporal=None):
        """One inter-capable unit: arbitration, prediction, residual coding,
        canvas and motion-cell updates in place.  `temporal`: the unit's
        (avail, mv) temporal candidate, or None.  Returns its decisions and
        levels."""
        lanes, n = self.lanes, 1 << log2
        oyf = self.origs[0][:, y0:y0 + n, x0:x0 + n].reshape(lanes, n * n)
        span = n + 2 * SEARCH_RANGE + 7
        win = self.win64[:, y0:y0 + span, x0:x0 + span]
        merge, mvp0, mvp1 = self.unit_lists(mcv, mif, x0, y0, n, temporal)
        arb = arbitrate(oyf, log2, win, merge, memv, mvp0, mvp1, icost, self.lamf, self.k)
        ui = arb["use_intra"]
        isel = device_const("prepass_inv", lambda: _PREPASS_INV, self.dev,
                            torch.int64)[imode.long()]
        planes = [(oyf, torch.where(ui[:, None], self.intra_pred(canvases[0], 0, x0, y0, log2,
                                                                  isel), arb["pred_inter"]),
                   self.qps[0], log2)]
        xc, yc, m = x0 >> 1, y0 >> 1, n >> 1
        cspan = m + SEARCH_RANGE + 3
        wins_c = torch.cat([w[:, yc:yc + cspan, xc:xc + cspan] for w in (self.winu, self.winv)])
        pred_mc = mc_chroma_window_batch(wins_c, arb["mv"].repeat(2, 1), m,
                                         SEARCH_RANGE).reshape(2, lanes, m * m)
        for p in (1, 2):
            pred_i = self.intra_pred(canvases[p], p, xc, yc, log2 - 1, isel)
            oc = self.origs[p][:, yc:yc + m, xc:xc + m].reshape(lanes, m * m)
            planes.append((oc, torch.where(ui[:, None], pred_i, pred_mc[p - 1]), self.qps[p],
                           log2 - 1))
        out = code_residual_planes(planes, ui, rdoq=self.rdoq, lam2=self.lam2)
        for p, (cv, (_, rec)) in enumerate(zip(canvases, out)):
            sh = 0 if p == 0 else 1
            nn = n >> sh
            cv[:, y0 >> sh:(y0 >> sh) + nn, x0 >> sh:(x0 >> sh) + nn] = rec.reshape(-1, nn, nn)
        levs = [lev for lev, _ in out]
        zero = (levs[0] == 0).all(-1) & (levs[1] == 0).all(-1) & (levs[2] == 0).all(-1)
        ct = torch.where(ui, CT_INTRA, torch.where(arb["is_merge"],
                                                   torch.where(zero, CT_SKIP, CT_MERGE),
                                                   CT_AMVP)).to(torch.int32)
        cs = (slice(None), slice(y0 >> 4, (y0 + n) >> 4), slice(x0 >> 4, (x0 + n) >> 4))
        mcv[cs] = arb["mv"][:, None, None, :]
        mif[cs] = (ct != CT_INTRA).to(torch.int32)[:, None, None]
        return dict(ct=ct, mv=arb["mv"], mi=arb["merge_idx"], mf=arb["mvp_flag"],
                    mvd=arb["mvd"], lev=levs)


def encode_frame_p64_fast(y, u, v, ref_y, ref_u, ref_v, qp: int, *, width: int, height: int,
                          merge_cand: int = 1, tmvp: bool = False, col_mv=None, col_inter=None,
                          rdoq: bool = False, xtile=(False, False)):
    """CTB64 P frame against one (loop-filtered) reference picture; all
    planes uint8 tensors on one device.  With `tmvp`, col_mv (16 nctb, 2)
    and col_inter (16 nctb,) are the reference picture's motion on the
    raster 16-grid (`temporal_cells`).  With `rdoq` every unit and the
    CU64 leaf quantize by RDOQ at the lane's lambda^2 (the prepasses keep
    the deadzone quantizer).  Output format of the reference."""
    if any(xtile):
        raise NotImplementedError("motion-constrained tiles are not ported")
    if not 1 <= merge_cand <= 5:
        raise ValueError("merge_cand must be in 1..5")
    dev = y.device
    cw, ch = width // S, height // S
    nctb = cw * ch
    k = merge_cand
    sched = schedule_r(cw, ch)
    lanes = sched["lanes"]
    qp_rows, qpc_rows, lam_rows = frame_rows(qp, nctb, dev)
    yi = y.to(torch.int32)
    oy64 = to_blocks(yi, S)
    ou32 = to_blocks(u.to(torch.int32), S // 2)
    ov32 = to_blocks(v.to(torch.int32), S // 2)
    oy32 = to_blocks(yi, 32).reshape(-1, 1024)
    oy16 = to_blocks(yi, 16).reshape(-1, 256)

    # ---- dense prepasses; lambda is one value a frame, so its mean is it
    lam_x1k = int(LAMBDA_X1K[int(qp)])
    me = {b: motion_search(y, ref_y, lam_x1k, block=b, search_range=SEARCH_RANGE,
                           width=width, height=height)[0] for b in (64, 32, 16)}
    refp_y = edge_pad(ref_y, REF_PAD)
    refp_u = edge_pad(ref_u, REF_PAD // 2)
    refp_v = edge_pad(ref_v, REF_PAD // 2)
    strips_y = sheared_ref_strips(refp_y, S, SEARCH_RANGE, ch, REF_PAD)
    strips_u = sheared_ref_strips(refp_u, S // 2, SEARCH_RANGE, ch, REF_PAD // 2, chroma=True)
    strips_v = sheared_ref_strips(refp_v, S // 2, SEARCH_RANGE, ch, REF_PAD // 2, chroma=True)
    sat = {}
    for b, lg, orig in ((64, 6, oy64.reshape(nctb, -1)), (32, 5, oy32), (16, 4, oy16)):
        f = S // b
        wins = extract_mc_neighborhoods(refp_y, b, SEARCH_RANGE, f * cw, f * ch, REF_PAD)
        pme = mc_luma_window_batch(wins, me[b], b, SEARCH_RANGE).reshape(orig.shape[0], -1)
        sat[b] = ck.satd_flat(pme, orig, lg).to(torch.float32)
        del wins, pme
    _, _, lam16 = frame_rows(qp, 16 * nctb, dev)
    _, _, lam32 = frame_rows(qp, 4 * nctb, dev)
    imode16, icost16 = cost_prepass_grid(yi, oy16, lam16, log2=4, cw=4 * cw, ch=4 * ch)
    imode32, icost32 = cost_prepass_grid(yi, oy32, lam32, log2=5, cw=2 * cw, ch=2 * ch)

    # ---- split decisions (SATD domain)
    best16 = torch.minimum(icost16, fma(lam16, _mebits(me[16]) + 3.0, sat[16]))
    best32 = torch.minimum(icost32, fma(lam32, _mebits(me[32]) + 3.0, sat[32]))
    cost64 = fma(lam_rows, _mebits(me[64]) + 3.0, sat[64])
    split64, split32 = split_decisions(best16, best32, cost64, lam32, lam_rows, cw, ch)

    # ---- per-CTB z-order gathers
    def z32(a):
        return zquads(a, 2 * cw, 2 * ch)

    def z16(a):
        return zquads(zquads(a, 4 * cw, 4 * ch), 2 * cw, 2 * ch)

    m32z, ic32z, me32z = z32(imode32), z32(icost32), z32(me[32])
    m16z, ic16z, me16z = z16(imode16), z16(icost16), z16(me[16])
    t_cells = []
    if tmvp:
        if col_mv is None:
            col_mv = torch.zeros((16 * nctb, 2), dtype=torch.int32, device=dev)
            col_inter = torch.zeros((16 * nctb,), dtype=torch.int32, device=dev)
        t_cells = temporal_cells(col_mv.to(dev), col_inter.to(dev), cw, ch)

    # ---- wave
    (oy_w, ou_w, ov_w, me64_w, me32_w, me16_w, im32_w, ic32_w, im16_w, ic16_w, s64_w, s32_w,
     qp_w, qpc_w, lam_w, *t_w) = wave_inputs(
        sched, nctb, [oy64, ou32, ov32, me[64], me32z, me16z, m32z, ic32z, m16z, ic16z,
                      split64, split32, qp_rows, qpc_rows, lam_rows, *t_cells])
    fl_w, fa_w, ftr_w = wave_flags(sched, cw, dev)
    nw = sched["n_waves"]
    m = S // 2

    def buf(shape, dtype=torch.int32):
        return torch.empty((nw, lanes) + shape, dtype=dtype, device=dev)

    outs = {"ct64": buf(()), "mv64": buf((2,)), "merge_idx64": buf(()),
            "mvp_flag64": buf(()), "mvd64": buf((2,)),
            "ct32": buf((4,)), "mv32": buf((4, 2)), "merge_idx32": buf((4,)),
            "mvp_flag32": buf((4,)), "mvd32": buf((4, 2)),
            "ct16": buf((4, 4)), "mv16": buf((4, 4, 2)), "merge_idx16": buf((4, 4)),
            "mvp_flag16": buf((4, 4)), "mvd16": buf((4, 4, 2)),
            "lev_y": buf((S * S,), torch.int16), "lev_cb": buf((m * m,), torch.int16),
            "lev_cr": buf((m * m,), torch.int16), "rec_y": buf((S, S), torch.uint8),
            "rec_u": buf((m, m), torch.uint8), "rec_v": buf((m, m), torch.uint8)}
    rings = [ring0(lanes, S, dev), ring0(lanes, m, dev), ring0(lanes, m, dev)]
    mv_rings = [torch.zeros((3, lanes, 4, 2), dtype=torch.int32, device=dev) for _ in (0, 1)]
    if_rings = [torch.zeros((3, lanes, 4), dtype=torch.int32, device=dev) for _ in (0, 1)]

    def shift(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)

    dec_keys = (("ct", "ct"), ("mv", "mv"), ("mi", "merge_idx"), ("mf", "mvp_flag"),
                ("mvd", "mvd"))
    for d in range(nw):
        fl, fa, ftr = fl_w[d], fa_w[d], ftr_w[d]
        (mvb, mvr), (ifb, ifr) = mv_rings, if_rings
        if tmvp:  # per unit: (avail, mv) of its temporal candidate
            t64m, t64o, t32m, t32o, t16m, t16o = (t[d] for t in t_w)
            t64 = (t64o != 0, t64m)
            t32 = [(t32o[:, q] != 0, t32m[:, q]) for q in range(4)]
            t16 = [[(t16o[:, q, z] != 0, t16m[:, q, z]) for z in range(4)] for q in range(4)]
        else:
            t64, t32, t16 = None, [None] * 4, [[None] * 4] * 4
        cells = {"L_mv": mvr[0], "L_if": ifr[0], "T_mv": shift(mvb[1]), "T_if": shift(ifb[1]),
                 "TR_mv": shift(mvb[0]), "TR_if": shift(ifb[0]),
                 "AL_mv": shift(mvb[2])[:, 3], "AL_if": shift(ifb[2])[:, 3]}
        wins = (strip_window_slice(strips_y, d, S, SEARCH_RANGE),
                strip_window_slice(strips_u, d, m, SEARCH_RANGE, chroma=True),
                strip_window_slice(strips_v, d, m, SEARCH_RANGE, chroma=True))
        wv = _Wave(lanes, dev, k, [ring_views(r, sz) for r, sz in zip(rings, (S, m, m))],
                   (oy_w[d], ou_w[d], ov_w[d]), (qp_w[d], qpc_w[d], qpc_w[d]), lam_w[d],
                   {"fl": fl, "fa": fa, "ftr": ftr, "fal": fl & fa}, cells, wins, rdoq)

        # split path: per 32-quadrant the CU32 leaf or four CU16s
        cvs = [torch.zeros((lanes, S >> sh, S >> sh), dtype=torch.int32, device=dev)
               for sh in (0, 1, 1)]
        mcv = torch.zeros((lanes, 4, 4, 2), dtype=torch.int32, device=dev)
        mif = torch.zeros((lanes, 4, 4), dtype=torch.int32, device=dev)
        d32, d16, lev_split = [], [], [[], [], []]
        for q32, (dy3, dx3) in enumerate(ZO):
            x3, y3 = dx3 * 32, dy3 * 32
            sel = s32_w[d][:, q32] != 0
            # the leaf reads only outside its quadrant: code it on copies,
            # then the CU16s on the state itself, and keep one per lane
            leaf = ([c.clone() for c in cvs], mcv.clone(), mif.clone())
            dec32 = wv.code_unit(*leaf, x3, y3, 5, im32_w[d][:, q32], ic32_w[d][:, q32],
                                 me32_w[d][:, q32], t32[q32])
            dec16 = [wv.code_unit(cvs, mcv, mif, x3 + dx * 16, y3 + dy * 16, 4,
                                  im16_w[d][:, q32, q16], ic16_w[d][:, q32, q16],
                                  me16_w[d][:, q32, q16], t16[q32][q16])
                     for q16, (dy, dx) in enumerate(ZO)]
            for p, (cv, lcv) in enumerate(zip(cvs, leaf[0])):
                sh = 0 if p == 0 else 1
                blk = (slice(None), slice(y3 >> sh, (y3 >> sh) + (32 >> sh)),
                       slice(x3 >> sh, (x3 >> sh) + (32 >> sh)))
                cv[blk] = torch.where(sel[:, None, None], cv[blk], lcv[blk])
                lev_split[p].append(torch.where(
                    sel[:, None], torch.cat([dq["lev"][p] for dq in dec16], 1), dec32["lev"][p]))
            cs = (slice(None), slice(y3 >> 4, (y3 >> 4) + 2), slice(x3 >> 4, (x3 >> 4) + 2))
            mcv[cs] = torch.where(sel[:, None, None, None], mcv[cs], leaf[1][cs])
            mif[cs] = torch.where(sel[:, None, None], mif[cs], leaf[2][cs])
            d32.append(dec32)
            d16.append(dec16)

        # CU64 leaf: inter only, one MC, four forced TU32s (chroma TU16s)
        merge64, mvp0, mvp1 = wv.unit_lists(torch.zeros_like(mcv), torch.zeros_like(mif),
                                            0, 0, 64, t64)
        big = torch.full((lanes,), BIG, dtype=torch.float32, device=dev)
        arb64 = arbitrate(oy_w[d].reshape(lanes, -1), 6, wins[0], merge64, me64_w[d], mvp0,
                          mvp1, big, lam_w[d], k)
        pred64 = mc_luma_window_batch(wins[0], arb64["mv"], S, SEARCH_RANGE)
        pc64 = mc_chroma_window_batch(torch.cat([wins[1], wins[2]]), arb64["mv"].repeat(2, 1),
                                      m, SEARCH_RANGE)
        l2 = wv.lam2
        lv4, rc4 = code_residual_rows(_quads(oy_w[d], 32).reshape(4 * lanes, -1),
                                      _quads(pred64, 32).reshape(4 * lanes, -1),
                                      qp_w[d].repeat(4), False, 5,
                                      rdoq=rdoq, lam2=None if l2 is None else l2.repeat(4))
        lc8, rc8 = code_residual_rows(
            _quads(torch.cat([ou_w[d], ov_w[d]]), 16).reshape(8 * lanes, -1),
            _quads(pc64, 16).reshape(8 * lanes, -1), qpc_w[d].repeat(8), False, 4,
            rdoq=rdoq, lam2=None if l2 is None else l2.repeat(8))
        # quadrant-major blocks of lanes; chroma [quadrant][plane][lane]
        lev64 = [lv4.reshape(4, lanes, -1).unbind(0), lc8.reshape(4, 2, lanes, -1)[:, 0].unbind(0),
                 lc8.reshape(4, 2, lanes, -1)[:, 1].unbind(0)]
        rec64 = [_unquads(rc4.reshape(4, lanes, 32, 32)),
                 _unquads(rc8.reshape(4, 2, lanes, 16, 16)[:, 0]),
                 _unquads(rc8.reshape(4, 2, lanes, 16, 16)[:, 1])]
        zero64 = (torch.cat([torch.cat(lv, 1) for lv in lev64], 1) == 0).all(-1)
        ct64 = torch.where(arb64["is_merge"], torch.where(zero64, CT_SKIP, CT_MERGE),
                           CT_AMVP).to(torch.int32)

        # select by split64
        sb = s64_w[d] != 0
        recs = [torch.where(sb[:, None, None], a, b) for a, b in zip(cvs, rec64)]
        levs = [torch.where(sb[:, None], torch.cat(a, 1), torch.cat(b, 1))
                for a, b in zip(lev_split, lev64)]
        mcv_out = torch.where(sb[:, None, None, None], mcv, arb64["mv"][:, None, None, :])
        mif_out = torch.where(sb[:, None, None], mif, 1)
        rings = [ring_push(r, rec, rec.shape[-1]) for r, rec in zip(rings, recs)]
        mv_rings = [torch.cat([mcv_out[None, :, 3], mvb[:2]]),
                    torch.cat([mcv_out[None, :, :, 3], mvr[:2]])]
        if_rings = [torch.cat([mif_out[None, :, 3], ifb[:2]]),
                    torch.cat([mif_out[None, :, :, 3], ifr[:2]])]

        outs["ct64"][d] = ct64
        outs["mv64"][d] = arb64["mv"]
        outs["merge_idx64"][d] = arb64["merge_idx"]
        outs["mvp_flag64"][d] = arb64["mvp_flag"]
        outs["mvd64"][d] = arb64["mvd"]
        for key, name in dec_keys:
            outs[name + "32"][d] = torch.stack([dq[key] for dq in d32], 1)
            outs[name + "16"][d] = torch.stack(
                [torch.stack([dq[key] for dq in d16[q]], 1) for q in range(4)], 1)
        for name, lev in zip(("lev_y", "lev_cb", "lev_cr"), levs):
            outs[name][d] = lev
        for name, rec in zip(("rec_y", "rec_u", "rec_v"), recs):
            outs[name][d] = rec

    res = {k_: wave_to_raster(sched, o) for k_, o in outs.items()}
    for name, plane, (hh, ww) in (("rec_y", "recon_y", (height, width)),
                                  ("rec_u", "recon_u", (height // 2, width // 2)),
                                  ("rec_v", "recon_v", (height // 2, width // 2))):
        res[plane] = from_blocks(res.pop(name), hh, ww)
    res.update(split64=split64, split32=split32, imode32=m32z, imode16=m16z)
    return res


def _unquads(q):
    """(4, L, h, h) z-order quadrants -> (L, 2h, 2h)."""
    top = torch.cat([q[0], q[1]], dim=-1)
    bot = torch.cat([q[2], q[3]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def quad_p64_trees_from_device(out, width: int, height: int):
    """Nested cu32-format trees (size 64) from the CTB64 P outputs.

    lev_y (nctb, 4096): z-order 32-quadrants of 1024; within a split
    quadrant, z-order 16-leaves of 256.  A CU64 leaf's levels use the same
    per-quadrant layout (its four TU32s)."""
    nctb = (width // 64) * (height // 64)
    s64 = host(out["split64"]).reshape(-1)
    s32 = host(out["split32"]).reshape(nctb, 4)
    d = {k: host(out[k]) for k in
         ("imode32", "imode16", "ct64", "mv64", "merge_idx64", "mvp_flag64", "mvd64", "ct32",
          "mv32", "merge_idx32", "mvp_flag32", "mvd32", "ct16", "mv16", "merge_idx16",
          "mvp_flag16", "mvd16")}
    lev_y, lev_cb, lev_cr = fetch_levels_i32(out)
    lev_y = lev_y.reshape(nctb, 4, 1024)
    lev_cb = lev_cb.reshape(nctb, 4, 256)
    lev_cr = lev_cr.reshape(nctb, 4, 256)

    def leaf(sz, ct, mode, mv, mi, mf, mvd, ly, lb, lr):
        if ct == CT_INTRA:
            return dict(size=sz, part=0, modes=[int(mode)], lev_y=ly, lev_cb=lb, lev_cr=lr)
        return dict(size=sz, ctype=int(ct), mv=(int(mv[0]), int(mv[1])), merge_idx=int(mi),
                    mvp_flag=int(mf), mvd=(int(mvd[0]), int(mvd[1])), lev_y=ly, lev_cb=lb,
                    lev_cr=lr)

    trees = []
    for i in range(nctb):
        if not s64[i]:
            trees.append(leaf(64, d["ct64"][i], 0, d["mv64"][i], d["merge_idx64"][i],
                              d["mvp_flag64"][i], d["mvd64"][i],
                              *place_quadrants(lev_y[i], lev_cb[i], lev_cr[i])))
            continue
        sub32 = []
        for q in range(4):
            if s32[i, q]:
                ly = lev_y[i, q].reshape(4, 16, 16)
                lb = lev_cb[i, q].reshape(4, 8, 8)
                lr = lev_cr[i, q].reshape(4, 8, 8)
                sub32.append(dict(size=32, split=[
                    leaf(16, d["ct16"][i, q, z], d["imode16"][i, q, z], d["mv16"][i, q, z],
                         d["merge_idx16"][i, q, z], d["mvp_flag16"][i, q, z],
                         d["mvd16"][i, q, z], ly[z], lb[z], lr[z]) for z in range(4)]))
            else:
                sub32.append(leaf(32, d["ct32"][i, q], d["imode32"][i, q], d["mv32"][i, q],
                                  d["merge_idx32"][i, q], d["mvp_flag32"][i, q],
                                  d["mvd32"][i, q], lev_y[i, q].reshape(32, 32),
                                  lev_cb[i, q].reshape(16, 16), lev_cr[i, q].reshape(16, 16)))
        trees.append(dict(size=64, split=sub32))
    return trees
