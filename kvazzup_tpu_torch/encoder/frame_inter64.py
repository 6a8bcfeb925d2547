"""CTB64 quadtree low-delay P encode, CU64 / CU32 / CU16 (counterpart of
kvazzup_tpu/encoder/frame_inter64.py without motion-constrained tiles).

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
16x16 grid.  `wave_loop` is the wave loop of this engine and of the B
engine (`frame_b64`).

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
from .frame_intra import (LAMBDA_X1K, P_PREPASS_MODES, _shift_lanes, cost_prepass_grid,
                          from_blocks, ring0, ring_push, to_blocks, wave_flags, wave_inputs,
                          wave_to_raster)
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


def motion_cells(rings, frames: int = 1):
    """The CTB-edge motion cells of a wave from the motion rings (per
    motion grid a bottom-row and a right-column ring of three waves, slot 0
    = wave d-1): the left CTB's right column "L", the above and above-right
    CTBs' bottom rows "T" and "TR" (shifted down one lane inside each
    picture's block of lanes) and the above-left CTB's corner cell "AL".
    Each entry is a tuple over the grids."""
    bot, right = rings

    def shift(x):
        return _shift_lanes(x, frames)

    return {"L": tuple(r[0] for r in right), "T": tuple(shift(b[1]) for b in bot),
            "TR": tuple(shift(b[0]) for b in bot), "AL": tuple(shift(b[2])[:, 3] for b in bot)}


def push_motion(rings, grids):
    """Push a wave's (L, 4, 4, ...) motion grids' bottom rows and right
    columns into the motion rings."""
    bot, right = rings
    return (tuple(torch.cat([g[None, :, 3], b[:2]]) for g, b in zip(grids, bot)),
            tuple(torch.cat([g[None, :, :, 3], r[:2]]) for g, r in zip(grids, right)))


def motion_rings0(lanes: int, motion, dev):
    """Empty motion rings for motion cells of grids shaped `motion`
    (`_Wave.MOTION`) over `lanes` lanes."""
    def ring(shape):
        return torch.zeros((3, lanes, 4) + shape, dtype=torch.int32, device=dev)

    return tuple(ring(sh) for sh in motion), tuple(ring(sh) for sh in motion)


class _Wave:
    """One wave's state and per-unit coding (the reference's wave body).

    The motion state of a CTB is a tuple of int32 grids over its 4x4 16x16
    motion cells, one per entry of MOTION (a cell's shape in that grid),
    whose first grid says whether a cell is inter: for P (inter flag
    (L, 4, 4), mv (L, 4, 4, 2)).  The B engine's subclass keeps (pred
    flags (L, 4, 4, 2), mv (L, 4, 4, 2, 2))."""

    MOTION = ((), (2,))

    def __init__(self, lanes, dev, k, views, origs, qps, lamf, flags, cells, wins, rdoq):
        self.lanes, self.dev, self.k = lanes, dev, k
        self.views, self.origs, self.qps, self.lamf = views, origs, qps, lamf
        self.lam2 = lamf * lamf if rdoq else None  # RDOQ's lambda^2 per lane
        self.rdoq = rdoq
        self.flags = flags
        self.cells = cells  # CTB-edge motion cells from the rings (`motion_cells`)
        self.wins = wins
        self.no = torch.zeros((lanes,), dtype=torch.bool, device=dev)
        self.none = self.motion_zeros(())

    def motion_zeros(self, cells):
        """Zero motion of the given cell shape ((): one per lane, (4, 4): a
        CTB's grids)."""
        return tuple(torch.zeros((self.lanes,) + cells + sh, dtype=torch.int32, device=self.dev)
                     for sh in self.MOTION)

    def motion_grids(self):
        """A CTB's empty motion state, one (L, 4, 4, ...) grid per entry."""
        return self.motion_zeros((4, 4))

    @staticmethod
    def inter(first):
        """Whether a cell is coded inter, from its first grid's entry."""
        return first != 0

    def mcell(self, mot, x: int, y: int, zcur: int):
        """(avail (L,), motion tuple) of the motion cell holding pixel
        (x, y), with z-scan availability (6.4.1); avail includes the inter
        test."""
        fl, fa, ftr, fal = (self.flags[f] for f in ("fl", "fa", "ftr", "fal"))
        c = self.cells
        if y >= 64 or (x >= 64 and y >= 0):
            return self.no, self.none
        if x < 0 and y < 0:
            m, f = c["AL"], fal
        elif x < 0:
            m, f = tuple(g[:, y >> 4] for g in c["L"]), fl
        elif y < 0 and x < 64:
            m, f = tuple(g[:, x >> 4] for g in c["T"]), fa
        elif y < 0:
            m, f = tuple(g[:, (x - 64) >> 4] for g in c["TR"]), ftr
        elif zscan(x, y) < zcur:
            m = tuple(g[:, y >> 4, x >> 4] for g in mot)
            return self.inter(m[0]), m
        else:
            return self.no, self.none
        return f & self.inter(m[0]), m

    def neighbours(self, mot, x0: int, y0: int, n: int):
        """The spatial candidates a1, b1, b0, a0, b2 of a unit (8.5.3.2.3)."""
        zcur = zscan(x0, y0)

        def mc(x, y):
            return self.mcell(mot, x, y, zcur)

        return (mc(x0 - 1, y0 + n - 1), mc(x0 + n - 1, y0 - 1), mc(x0 + n, y0 - 1),
                mc(x0 - 1, y0 + n), mc(x0 - 1, y0 - 1))

    def unit_lists(self, mot, x0: int, y0: int, n: int, temporal=None):
        a1, b1, b0, a0, b2 = ((av, m[1]) for av, m in self.neighbours(mot, x0, y0, n))
        merge = merge_list_cells({"a1": a1, "b1": b1, "b0": b0, "a0": a0, "b2": b2}, self.k,
                                 temporal)
        return (merge, *amvp_cells([a0, a1], [b0, b1, b2], temporal))

    def intra_pred(self, canvas, p: int, x0: int, y0: int, log2: int, sel):
        n = 1 << log2
        a = unit_walk(canvas, self.views[p], seg_spec(x0, y0, n, S >> (p > 0)), n, self.flags)
        preds = ck.predict_modes_subset_flat(a, log2, p == 0, P_PREPASS_MODES)
        return preds.gather(1, sel[:, None, None].expand(-1, 1, n * n))[:, 0]

    def code_planes(self, canvases, x0: int, y0: int, log2: int, arb, imode, pred_c):
        """Predict (intra where `arb` chose it, else the inter predictions:
        arb["pred_inter"] for luma, pred_c (2, L, m^2) for Cb, Cr) and code
        a unit's three planes, its recon into the canvases in place.
        Returns (levels per plane, CU type)."""
        lanes, n = self.lanes, 1 << log2
        ui = arb["use_intra"]
        isel = device_const("prepass_inv", lambda: _PREPASS_INV, self.dev,
                            torch.int64)[imode.long()]
        pred_y = torch.where(ui[:, None], self.intra_pred(canvases[0], 0, x0, y0, log2, isel),
                             arb["pred_inter"])
        planes = [(self.orig_flat(x0, y0, n), pred_y, self.qps[0], log2)]
        xc, yc, m = x0 >> 1, y0 >> 1, n >> 1
        for p in (1, 2):
            pred_i = self.intra_pred(canvases[p], p, xc, yc, log2 - 1, isel)
            oc = self.origs[p][:, yc:yc + m, xc:xc + m].reshape(lanes, m * m)
            planes.append((oc, torch.where(ui[:, None], pred_i, pred_c[p - 1]), self.qps[p],
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
        return levs, ct

    def orig_flat(self, x0: int, y0: int, n: int):
        return self.origs[0][:, y0:y0 + n, x0:x0 + n].reshape(self.lanes, n * n)

    @staticmethod
    def unit_window(win, x0: int, y0: int, n: int, chroma: bool = False):
        span = n + (SEARCH_RANGE + 3 if chroma else 2 * SEARCH_RANGE + 7)
        return win[:, y0:y0 + span, x0:x0 + span]

    def code_unit(self, canvases, mot, x0: int, y0: int, log2: int, imode, icost, memv,
                  temporal=None):
        """One inter-capable unit: arbitration, prediction, residual coding,
        canvas and motion-cell updates in place.  `temporal`: the unit's
        (avail, mv) temporal candidate, or None.  Returns its decisions and
        levels."""
        lanes, n = self.lanes, 1 << log2
        merge, mvp0, mvp1 = self.unit_lists(mot, x0, y0, n, temporal)
        arb = arbitrate(self.orig_flat(x0, y0, n), log2, self.unit_window(self.wins[0], x0, y0, n),
                        merge, memv, mvp0, mvp1, icost, self.lamf, self.k)
        xc, yc, m = x0 >> 1, y0 >> 1, n >> 1
        wins_c = torch.cat([self.unit_window(w, xc, yc, m, True) for w in self.wins[1:]])
        pred_mc = mc_chroma_window_batch(wins_c, arb["mv"].repeat(2, 1), m,
                                         SEARCH_RANGE).reshape(2, lanes, m * m)
        levs, ct = self.code_planes(canvases, x0, y0, log2, arb, imode, pred_mc)
        cs = (slice(None), slice(y0 >> 4, (y0 + n) >> 4), slice(x0 >> 4, (x0 + n) >> 4))
        mot[1][cs] = arb["mv"][:, None, None, :]
        mot[0][cs] = (ct != CT_INTRA).to(torch.int32)[:, None, None]
        return dict(ct=ct, mv=arb["mv"], merge_idx=arb["merge_idx"],
                    mvp_flag=arb["mvp_flag"], mvd=arb["mvd"], lev=levs)

    def split_path(self, mot, s32, unit_args):
        """The split side of a CTB: per 32-quadrant the CU32 leaf or its four
        CU16s, chosen per lane by s32 (L, 4).  unit_args(q32, q16) gives a
        unit's arguments after (x0, y0, log2) (q16 None: the CU32).  `mot`
        is updated in place.  Returns (canvases, CU32 decisions, CU16
        decisions per quadrant, per plane the quadrants' levels)."""
        cvs = [torch.zeros((self.lanes, S >> sh, S >> sh), dtype=torch.int32, device=self.dev)
               for sh in (0, 1, 1)]
        d32, d16, lev_split = [], [], [[], [], []]
        for q32, (dy3, dx3) in enumerate(ZO):
            x3, y3 = dx3 * 32, dy3 * 32
            sel = s32[:, q32] != 0
            # the leaf reads only outside its quadrant: code it on copies,
            # then the CU16s on the state itself, and keep one per lane
            leaf_cv, leaf_mot = [c.clone() for c in cvs], tuple(g.clone() for g in mot)
            dec32 = self.code_unit(leaf_cv, leaf_mot, x3, y3, 5, *unit_args(q32, None))
            dec16 = [self.code_unit(cvs, mot, x3 + dx * 16, y3 + dy * 16, 4, *unit_args(q32, q16))
                     for q16, (dy, dx) in enumerate(ZO)]
            for p, (cv, lcv) in enumerate(zip(cvs, leaf_cv)):
                sh = 0 if p == 0 else 1
                blk = (slice(None), slice(y3 >> sh, (y3 >> sh) + (32 >> sh)),
                       slice(x3 >> sh, (x3 >> sh) + (32 >> sh)))
                cv[blk] = torch.where(sel[:, None, None], cv[blk], lcv[blk])
                lev_split[p].append(torch.where(
                    sel[:, None], torch.cat([dq["lev"][p] for dq in dec16], 1), dec32["lev"][p]))
            cs = (slice(None), slice(y3 >> 4, (y3 >> 4) + 2), slice(x3 >> 4, (x3 >> 4) + 2))
            for g, lg in zip(mot, leaf_mot):
                g[cs] = torch.where(sel.reshape((-1,) + (1,) * (g.ndim - 1)), g[cs], lg[cs])
            d32.append(dec32)
            d16.append(dec16)
        return cvs, d32, d16, lev_split

    def code_cu64(self, pred64, pc64):
        """The CU64 leaf's residual: its four forced TU32s (luma pred64
        (L, 64, 64)) and eight chroma TU16s (pc64 (2L, 32, 32), Cb then Cr),
        one call each.  Returns (levels per plane as four quadrant tensors,
        recon per plane, all-zero per lane)."""
        lanes, l2 = self.lanes, self.lam2
        lv4, rc4 = code_residual_rows(_quads(self.origs[0], 32).reshape(4 * lanes, -1),
                                      _quads(pred64, 32).reshape(4 * lanes, -1),
                                      self.qps[0].repeat(4), False, 5,
                                      rdoq=self.rdoq, lam2=None if l2 is None else l2.repeat(4))
        lc8, rc8 = code_residual_rows(
            _quads(torch.cat([self.origs[1], self.origs[2]]), 16).reshape(8 * lanes, -1),
            _quads(pc64, 16).reshape(8 * lanes, -1), self.qps[1].repeat(8), False, 4,
            rdoq=self.rdoq, lam2=None if l2 is None else l2.repeat(8))
        # quadrant-major blocks of lanes; chroma [quadrant][plane][lane]
        lev64 = [lv4.reshape(4, lanes, -1).unbind(0), lc8.reshape(4, 2, lanes, -1)[:, 0].unbind(0),
                 lc8.reshape(4, 2, lanes, -1)[:, 1].unbind(0)]
        rec64 = [_unquads(rc4.reshape(4, lanes, 32, 32)),
                 _unquads(rc8.reshape(4, 2, lanes, 16, 16)[:, 0]),
                 _unquads(rc8.reshape(4, 2, lanes, 16, 16)[:, 1])]
        zero64 = (torch.cat([torch.cat(lv, 1) for lv in lev64], 1) == 0).all(-1)
        return lev64, rec64, zero64


def wave_loop(sched, nb: int, width: int, height: int, dev, motion, splits, make_wave,
              unit_args, leaf64):
    """The wave loop of the P and B engines over `nb` pictures side by side
    in the lanes.  make_wave(d, views, flags, cells) builds wave d's
    `_Wave` from its ring views, availability flags and CTB-edge motion
    cells; unit_args(d, q32, q16) gives a unit's arguments after (x0, y0,
    log2) (q16 None: the CU32); leaf64(wv, d) codes the CU64 leaf and
    returns (its decisions {name: (L, ...)}, levels per plane as quadrant
    lists, recon per plane, motion per grid (L, ...)).  `motion`: the
    wave's `MOTION`; splits: the (n_waves, L) split64 and (n_waves, L, 4)
    split32 flags.  Returns every decision, the levels and the recon
    planes, each with a leading axis of nb."""
    cw, ch = width // S, height // S
    lanes, nw, m = nb * sched["lanes"], sched["n_waves"], S // 2
    fl_w, fa_w, ftr_w = wave_flags(sched, cw, dev, nb)
    rings = [ring0(lanes, S, dev), ring0(lanes, m, dev), ring0(lanes, m, dev)]
    mrings = motion_rings0(lanes, motion, dev)
    outs = {}

    def store(d, name, val):
        if name not in outs:
            dtype = {"lev": torch.int16, "rec": torch.uint8}.get(name[:3], torch.int32)
            outs[name] = torch.empty((nw,) + tuple(val.shape), dtype=dtype, device=dev)
        outs[name][d] = val

    for d in range(nw):
        fl, fa, ftr = fl_w[d], fa_w[d], ftr_w[d]
        wv = make_wave(d, [ring_views(r, sz, nb) for r, sz in zip(rings, (S, m, m))],
                       {"fl": fl, "fa": fa, "ftr": ftr, "fal": fl & fa},
                       motion_cells(mrings, nb))
        mot = wv.motion_grids()
        cvs, d32, d16, lev_split = wv.split_path(
            mot, splits[1][d], lambda q32, q16, d=d: unit_args(d, q32, q16))
        dec64, lev64, rec64, mot64 = leaf64(wv, d)

        # select by split64
        sb = splits[0][d] != 0
        recs = [torch.where(sb[:, None, None], a, b) for a, b in zip(cvs, rec64)]
        levs = [torch.where(sb[:, None], torch.cat(a, 1), torch.cat(b, 1))
                for a, b in zip(lev_split, lev64)]
        mot_out = tuple(torch.where(sb.reshape((-1,) + (1,) * (g.ndim - 1)), g, g64[:, None, None])
                        for g, g64 in zip(mot, mot64))
        rings = [ring_push(r, rec, rec.shape[-1]) for r, rec in zip(rings, recs)]
        mrings = push_motion(mrings, mot_out)

        for name, val in dec64.items():
            store(d, name, val)
        for name in (key for key in d32[0] if key != "lev"):
            store(d, name + "32", torch.stack([dq[name] for dq in d32], 1))
            store(d, name + "16", torch.stack(
                [torch.stack([dq[name] for dq in d16[q]], 1) for q in range(4)], 1))
        for name, val in zip(("lev_y", "lev_cb", "lev_cr", "rec_y", "rec_u", "rec_v"),
                             levs + recs):
            store(d, name, val)

    res = {key: wave_to_raster(sched, o, nb).reshape((nb, cw * ch) + tuple(o.shape[2:]))
           for key, o in outs.items()}
    for name, plane, (hh, ww) in (("rec_y", "recon_y", (height, width)),
                                  ("rec_u", "recon_u", (height // 2, width // 2)),
                                  ("rec_v", "recon_v", (height // 2, width // 2))):
        rec = res.pop(name)
        res[plane] = torch.stack([from_blocks(rec[b], hh, ww) for b in range(nb)])
    return res


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
    m = S // 2
    big = torch.full((lanes,), BIG, dtype=torch.float32, device=dev)

    if tmvp:  # per unit: (avail, mv) of its temporal candidate
        t64m, t64o, t32m, t32o, t16m, t16o = t_w
        t64o, t32o, t16o = t64o != 0, t32o != 0, t16o != 0

    def make_wave(d, views, flags, cells):
        wins = (strip_window_slice(strips_y, d, S, SEARCH_RANGE),
                strip_window_slice(strips_u, d, m, SEARCH_RANGE, chroma=True),
                strip_window_slice(strips_v, d, m, SEARCH_RANGE, chroma=True))
        return _Wave(lanes, dev, k, views, (oy_w[d], ou_w[d], ov_w[d]),
                     (qp_w[d], qpc_w[d], qpc_w[d]), lam_w[d], flags, cells, wins, rdoq)

    # split path: per 32-quadrant the CU32 leaf or four CU16s
    def unit_args(d, q32, q16):
        if q16 is None:
            t = (t32o[d][:, q32], t32m[d][:, q32]) if tmvp else None
            return im32_w[d][:, q32], ic32_w[d][:, q32], me32_w[d][:, q32], t
        t = (t16o[d][:, q32, q16], t16m[d][:, q32, q16]) if tmvp else None
        return im16_w[d][:, q32, q16], ic16_w[d][:, q32, q16], me16_w[d][:, q32, q16], t

    def leaf64(wv, d):
        """CU64 leaf: inter only, one MC, four forced TU32s (chroma TU16s)."""
        merge64, mvp0, mvp1 = wv.unit_lists(wv.motion_grids(), 0, 0, 64,
                                            (t64o[d], t64m[d]) if tmvp else None)
        wins = wv.wins
        arb64 = arbitrate(oy_w[d].reshape(lanes, -1), 6, wins[0], merge64, me64_w[d], mvp0,
                          mvp1, big, lam_w[d], k)
        pred64 = mc_luma_window_batch(wins[0], arb64["mv"], S, SEARCH_RANGE)
        pc64 = mc_chroma_window_batch(torch.cat([wins[1], wins[2]]), arb64["mv"].repeat(2, 1),
                                      m, SEARCH_RANGE)
        lev64, rec64, zero64 = wv.code_cu64(pred64, pc64)
        ct64 = torch.where(arb64["is_merge"], torch.where(zero64, CT_SKIP, CT_MERGE),
                           CT_AMVP).to(torch.int32)
        dec = {"ct64": ct64, "mv64": arb64["mv"],
               "merge_idx64": arb64["merge_idx"], "mvp_flag64": arb64["mvp_flag"],
               "mvd64": arb64["mvd"]}
        return dec, lev64, rec64, (torch.ones_like(ct64), arb64["mv"])

    res = wave_loop(sched, 1, width, height, dev, _Wave.MOTION, (s64_w, s32_w), make_wave,
                    unit_args, leaf64)
    res = {key: val[0] for key, val in res.items()}
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
