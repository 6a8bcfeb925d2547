"""CTB64 quadtree IDR encode, CU64 / CU32 / CU16 (counterpart of
kvazzup_tpu/encoder/frame_intra64.py).

Dense prepasses on original-pixel boundaries decide the whole split tree
(split64 and the four split32 flags of each CTB) and every mode: the
35-mode RD prepass on the 16- and 32-grids (`frame_intra.rd_prepass_grid`)
and the CU64 leaf's (`rd64_prepass`: one mode for its four forced TU32s).
The row-aligned wavefront over the 64-grid then only reconstructs.  Each
wave codes, per lane, both the CU64 leaf (four TU32s; chroma four TU16s)
and the split path (per 32-quadrant a CU32 leaf and four CU16s, z-order
on a per-lane canvas), and the pre-decided flags select the survivors.

Boundary walks come from a z-scan segment resolver (`seg_spec`): each of a
unit's five walk segments resolves statically to ring slices, canvas
slices or unavailable, with availability by the 6.4.1 z-scan order, so
every unit shares one code path (`unit_walk`).  Trees are the reference's
cu32 format (`quad_trees_from_device64`), for `entropy.quad` and
`cu32.quad_bs_maps`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tables import CHROMA_QP_TABLE
from ..ops import ctu_kernels as ck
from ..ops.costs import bits_row_sum, fma
from ..ops.hopper_q import code_residual_planes, code_residual_rows
from .frame_intra import (LAMBDA, _shift_lanes, from_blocks, mode_bits_table, mode_sweep,
                          rd_prepass_grid, ring0, ring_push, to_blocks, wave_flags, wave_inputs,
                          wave_to_raster)
from .frame_intra32 import ZO, subst_quad
from .wavefront import schedule_r

S = 64


def zscan(x: int, y: int) -> int:
    """Morton index of the 4x4 cell containing (x, y) within its CTB."""
    cx, cy = x >> 2, y >> 2
    m = 0
    for k in range(8):
        m |= ((cx >> k) & 1) << (2 * k)
        m |= ((cy >> k) & 1) << (2 * k + 1)
    return m


def seg_spec(x0: int, y0: int, n: int, size: int):
    """Static walk-segment sources of a unit at (x0, y0, n) inside a
    `size` CTB: per segment (below-left, left, corner, top, top-right) a
    (source, flag) pair.  A source is a tag tuple resolved by `unit_walk`;
    a flag is True / False or one of 'fl' / 'fa' / 'ftr' / 'fal' (the lane's
    CTB-grid neighbour flags).  Availability follows the z-scan rule (6.4.1)
    inside the CTB and the CTB-grid flags across its edges."""
    zcur = zscan(x0, y0)
    if x0 == 0:
        left = (("L", y0), "fl")
        bl = (("L", y0 + n), "fl") if y0 + 2 * n <= size else (("Z",), False)
    else:
        left = (("CCOL", x0 - 1, y0), True)
        if y0 + 2 * n <= size and zscan(x0 - 1, y0 + n) < zcur:
            bl = (("CCOL", x0 - 1, y0 + n), True)
        else:
            bl = (("Z",), False)
    if x0 == 0 and y0 == 0:
        corner = (("CPIX",), "fal")
    elif x0 == 0:
        corner = (("LPX", y0 - 1), "fl")
    elif y0 == 0:
        corner = (("TPX", x0 - 1), "fa")
    else:
        corner = (("CPX", y0 - 1, x0 - 1), True)
    top = (("T", x0), "fa") if y0 == 0 else (("CROW", y0 - 1, x0), True)
    if y0 == 0:
        if x0 + 2 * n <= size:
            tr = (("T", x0 + n), "fa")
        elif x0 + n == size:
            tr = (("TR", 0), "ftr")
        else:
            tr = (("Z",), False)
    elif x0 + 2 * n <= size and zscan(x0 + n, y0 - 1) < zcur:
        tr = (("CROW", y0 - 1, x0 + n), True)
    else:
        tr = (("Z",), False)
    return bl, left, corner, top, tr


def unit_walk(canvas, rings, spec, n: int, flags, bd: int = 8):
    """A unit's substituted (L, 4n + 1) boundary walk.

    canvas: (L, size, size) in-wave recon canvas; rings: dict of Lcol
    (L, size), Trow (L, size), TRrow (L, size), Cpix (L, 1); spec from
    `seg_spec`; flags: dict fl / fa / ftr / fal -> (L,) bool."""
    lanes = canvas.shape[0]

    def fvec(f):
        if f is True or f is False:
            return torch.full((lanes,), f, dtype=torch.bool, device=canvas.device)
        return flags[f]

    def seg(src):
        tag = src[0]
        if tag == "Z":
            return torch.zeros((lanes, n), dtype=torch.int32, device=canvas.device)
        if tag == "L":  # ring left column from row src[1], bottom-up
            return rings["Lcol"][:, src[1]:src[1] + n].flip(-1)
        if tag == "T":
            return rings["Trow"][:, src[1]:src[1] + n]
        if tag == "TR":
            return rings["TRrow"][:, src[1]:src[1] + n]
        if tag == "CCOL":  # canvas column x from row y, bottom-up
            return canvas[:, src[2]:src[2] + n, src[1]].flip(-1)
        if tag == "CROW":
            return canvas[:, src[1], src[2]:src[2] + n]
        raise AssertionError(tag)

    def px(src):
        tag = src[0]
        if tag == "CPIX":
            return rings["Cpix"]
        if tag == "LPX":
            return rings["Lcol"][:, src[1]:src[1] + 1]
        if tag == "TPX":
            return rings["Trow"][:, src[1]:src[1] + 1]
        if tag == "CPX":
            return canvas[:, src[1], src[2]:src[2] + 1]
        raise AssertionError(tag)

    (bl_s, bl_f), (l_s, l_f), (c_s, c_f), (t_s, t_f), (tr_s, tr_f) = spec
    return subst_quad(seg(bl_s), seg(l_s), px(c_s), seg(t_s), seg(tr_s),
                      fvec(bl_f), fvec(l_f), fvec(c_f), fvec(t_f), fvec(tr_f), bd=bd)


def ring_views(ring, size: int, frames: int = 1):
    """The walk sources of a 3-wave ring (slot 0 = wave d-1): the left
    CTB's right column, and the above / above-right / above-left CTBs'
    bottom rows and corner sample, shifted down one lane (lane k = CTB row
    k; with `frames` pictures, inside each picture's block of lanes)."""
    rb, rr = ring

    def shift(x):
        return _shift_lanes(x, frames)

    return {"Lcol": rr[0], "Trow": shift(rb[1]), "TRrow": shift(rb[0]),
            "Cpix": shift(rb[2])[:, size - 1:size]}


def zquads(a, cols: int, rows: int):
    """(rows * cols, ...) raster blocks -> (rows/2 * cols/2, 4, ...): each
    2x2 group's blocks in z-order."""
    g = a.reshape((rows, cols) + tuple(a.shape[1:]))
    return torch.stack([g[dy::2, dx::2].reshape((-1,) + tuple(a.shape[1:]))
                        for dy, dx in ZO], dim=1)


def sum4(a):
    """In-order sum over dim 1 of (B, 4, ...) float32 (the reference's)."""
    return ((a[:, 0] + a[:, 1]) + a[:, 2]) + a[:, 3]


def rd64_prepass(sweep32, oy32_flat, qp_rows, lam_rows, *, cw64: int, ch64: int, k: int = 2):
    """CU64 leaf mode + RD estimate from the 32-grid sweep `sweep32`
    (`mode_sweep` at log2 5): the four quadrants' SATDs summed per CTB, the
    top k modes ranked with the DC-neighbour MPM bits, then each quadrant
    coded as a TU32 at each candidate.  Returns (mode (n64,) int32, RD
    cost (n64,) float32)."""
    preds, satd, _, _, _ = sweep32
    n64 = cw64 * ch64
    idx = torch.as_tensor(zquad_index(cw64, ch64), device=satd.device)  # (n64, 4)
    satd64 = sum4(satd[idx])
    bits = mode_bits_table(torch.ones((n64,), dtype=torch.int32, device=satd.device))
    cost = fma(lam_rows[:, None], bits, satd64)
    cand = torch.sort(cost, dim=1, stable=True).indices[:, :k]
    candp = preds[idx[:, :, None], cand[:, None, :]]  # (n64, 4, k, 1024)
    oy4 = oy32_flat[idx].reshape(n64 * 4, 1024)
    lev, rec = code_residual_rows(oy4, candp.reshape(-1, 1024), qp_rows.repeat_interleave(4),
                                  True, 5, group=k)
    lev, rec = lev.reshape(n64, 4, k, 1024), rec.reshape(n64, 4, k, 1024)
    sse = ((rec - oy4.reshape(n64, 4, 1, 1024)) ** 2).sum(dim=-1, dtype=torch.int32)
    lam2 = (lam_rows * lam_rows)[:, None]
    rd = fma(lam2, sum4(bits_row_sum(lev)) + bits.gather(1, cand),
             sum4(sse.to(torch.float32)))
    best_k = rd.argmin(dim=1)[:, None]
    return cand.gather(1, best_k)[:, 0].to(torch.int32), rd.gather(1, best_k)[:, 0]


def zquad_index(cw64: int, ch64: int) -> np.ndarray:
    """(n64, 4) raster index on the 32-grid of each CTB's quadrants in
    z-order."""
    r = np.arange(ch64)[:, None]
    c = np.arange(cw64)[None, :]
    return np.stack([((2 * r + dy) * 2 * cw64 + 2 * c + dx).reshape(-1) for dy, dx in ZO], 1)


def frame_rows(qp: int, nctb: int, device):
    """Per-CTB qp, chroma qp and lambda rows for a scalar slice QP."""
    qp = int(qp)
    return (torch.full((nctb,), qp, dtype=torch.int32, device=device),
            torch.full((nctb,), int(CHROMA_QP_TABLE[min(max(qp, 0), 57)]), dtype=torch.int32,
                       device=device),
            torch.full((nctb,), float(LAMBDA[qp]), dtype=torch.float32, device=device))


def split_decisions(best16, best32, cost64, lam32, lam64, cw: int, ch: int):
    """The quadtree from per-block costs: split32 (nctb, 4) where four CU16s
    (+ 5 lambda^2 of flags) beat the CU32 (+ 1), split64 (nctb,) where the
    four best 32-subtrees beat the CU64, both int32."""
    lam2_32 = lam32 * lam32
    lam2 = lam64 * lam64
    sum16 = sum4(zquads(best16, 4 * cw, 4 * ch))
    with16 = fma(lam2_32, 5.0, sum16)
    leaf32 = best32 + lam2_32
    split32 = with16 < leaf32
    sum32 = sum4(zquads(torch.minimum(with16, leaf32), 2 * cw, 2 * ch))
    split64 = (sum32 + lam2 < cost64 + lam2).to(torch.int32)
    return split64, zquads(split32.to(torch.int32), 2 * cw, 2 * ch)


def _select(preds, mode):
    return preds.gather(1, mode.long()[:, None, None].expand(-1, 1, preds.shape[2]))[:, 0]


def encode_frame_intra64_fast(y, u, v, qp: int, *, width: int, height: int,
                              rdoq: bool = False, bit_depth: int = 8):
    """CTB64 IDR frame: y (H, W), u, v (H/2, W/2) uint8 tensors on one
    device.  With `rdoq` the waves quantize by RDOQ at each lane's
    lambda^2 (the prepasses keep the deadzone quantizer).  Returns the
    split flags, modes, levels (int16, z-order 32-quadrants of each CTB)
    and the reconstruction."""
    if bit_depth != 8:
        raise NotImplementedError("Main10 (bit_depth 10) is not ported")
    dev = y.device
    cw, ch = width // S, height // S
    nctb = cw * ch
    sched = schedule_r(cw, ch)
    lanes = sched["lanes"]
    qp_rows, qpc_rows, lam_rows = frame_rows(qp, nctb, dev)
    yi = y.to(torch.int32)
    oy64 = to_blocks(yi, S)
    ou32 = to_blocks(u.to(torch.int32), S // 2)
    ov32 = to_blocks(v.to(torch.int32), S // 2)

    # ---- dense prepasses at the three levels
    qp16, _, lam16 = frame_rows(qp, 16 * nctb, dev)  # raster rows of the 16- and 32-grids
    qp32, _, lam32 = frame_rows(qp, 4 * nctb, dev)
    oy16 = to_blocks(yi, 16).reshape(-1, 256)
    oy32 = to_blocks(yi, 32).reshape(-1, 1024)
    mode16, rd16 = rd_prepass_grid(yi, oy16, qp16, lam16, log2=4, cw=4 * cw, ch=4 * ch)
    sweep32 = mode_sweep(yi, oy32, lam32, 2 * cw, 2 * ch, None, 5)
    mode32, rd32 = rd_prepass_grid(yi, oy32, qp32, lam32, log2=5, cw=2 * cw, ch=2 * ch,
                                   sweep=sweep32)
    mode64, rd64 = rd64_prepass(sweep32, oy32, qp_rows, lam_rows, cw64=cw, ch64=ch)
    del sweep32  # the (n32, 35, 1024) predictions: free them before the waves
    split64, split32 = split_decisions(rd16, rd32, rd64, lam32, lam_rows, cw, ch)
    m32z = zquads(mode32, 2 * cw, 2 * ch)
    m16z = zquads(zquads(mode16, 4 * cw, 4 * ch), 2 * cw, 2 * ch)

    # ---- wave
    (oy_w, ou_w, ov_w, m64_w, m32_w, m16_w, s64_w, s32_w, qp_w, qpc_w, lam_w) = wave_inputs(
        sched, nctb, [oy64, ou32, ov32, mode64, m32z, m16z, split64, split32, qp_rows,
                      qpc_rows, lam_rows])
    fl_w, fa_w, ftr_w = wave_flags(sched, cw, dev)
    nw = sched["n_waves"]
    m = S // 2
    lev_y_w = torch.empty((nw, lanes, S * S), dtype=torch.int16, device=dev)
    lev_c_w = torch.empty((2, nw, lanes, m * m), dtype=torch.int16, device=dev)
    rec_y_w = torch.empty((nw, lanes, S, S), dtype=torch.uint8, device=dev)
    rec_c_w = torch.empty((2, nw, lanes, m, m), dtype=torch.uint8, device=dev)
    rings = [ring0(lanes, S, dev), ring0(lanes, m, dev), ring0(lanes, m, dev)]
    for d in range(nw):
        fl, fa, ftr = fl_w[d], fa_w[d], ftr_w[d]
        flags = {"fl": fl, "fa": fa, "ftr": ftr, "fal": fl & fa}
        views = [ring_views(r, sz) for r, sz in zip(rings, (S, m, m))]
        origs = (oy_w[d], ou_w[d], ov_w[d])
        qps = (qp_w[d], qpc_w[d], qpc_w[d])
        lam2 = lam_w[d] * lam_w[d] if rdoq else None

        def unit(canvases, x0, y0, log2, mode):
            """Predict and code one unit's three planes on the canvases (in
            place); returns the three planes' levels."""
            planes = []
            for p, (cv, view, orig) in enumerate(zip(canvases, views, origs)):
                sh = 0 if p == 0 else 1
                lg, xs, ys = log2 - sh, x0 >> sh, y0 >> sh
                n = 1 << lg
                spec = seg_spec(xs, ys, n, S >> sh)
                a = unit_walk(cv, view, spec, n, flags)
                pred = _select(ck.predict_all_modes_flat(a, lg, p == 0), mode)
                o = orig[:, ys:ys + n, xs:xs + n].reshape(lanes, n * n)
                planes.append((o, pred, qps[p], lg))
            out = code_residual_planes(planes, True, rdoq=rdoq, lam2=lam2)
            for p, (cv, (lev, rec)) in enumerate(zip(canvases, out)):
                sh = 0 if p == 0 else 1
                n = 1 << (log2 - sh)
                cv[:, y0 >> sh:(y0 >> sh) + n, x0 >> sh:(x0 >> sh) + n] = rec.reshape(-1, n, n)
            return [lev for lev, _ in out]

        def canvases():
            return [torch.zeros((lanes, S >> sh, S >> sh), dtype=torch.int32, device=dev)
                    for sh in (0, 1, 1)]

        # split path: per 32-quadrant, the CU32 leaf or four CU16s
        split_cv = canvases()
        lev_split = [[], [], []]
        for q32, (dy3, dx3) in enumerate(ZO):
            x3, y3 = dx3 * 32, dy3 * 32
            sel = s32_w[d][:, q32] != 0
            # the leaf reads only outside its quadrant: code it first, keep
            # its recon aside, then run the CU16s on the canvas itself
            leaf_cv = [c.clone() for c in split_cv]
            lev_leaf = unit(leaf_cv, x3, y3, 5, m32_w[d][:, q32])
            lev16 = [unit(split_cv, x3 + dx * 16, y3 + dy * 16, 4, m16_w[d][:, q32, q16])
                     for q16, (dy, dx) in enumerate(ZO)]
            for p, (cv, lcv) in enumerate(zip(split_cv, leaf_cv)):
                sh = 0 if p == 0 else 1
                blk = (slice(None), slice(y3 >> sh, (y3 >> sh) + (32 >> sh)),
                       slice(x3 >> sh, (x3 >> sh) + (32 >> sh)))
                cv[blk] = torch.where(sel[:, None, None], cv[blk], lcv[blk])
                lev_split[p].append(torch.where(sel[:, None], torch.cat([l[p] for l in lev16], 1),
                                                lev_leaf[p]))
        # CU64 leaf: four TU32s at one mode
        leaf64_cv = canvases()
        lev64 = [[], [], []]
        for dy3, dx3 in ZO:
            for p, lev in enumerate(unit(leaf64_cv, dx3 * 32, dy3 * 32, 5, m64_w[d])):
                lev64[p].append(lev)

        s64 = s64_w[d] != 0
        recs = [torch.where(s64[:, None, None], a, b) for a, b in zip(split_cv, leaf64_cv)]
        levs = [torch.where(s64[:, None], torch.cat(a, 1), torch.cat(b, 1))
                for a, b in zip(lev_split, lev64)]
        rings = [ring_push(r, rec, rec.shape[-1]) for r, rec in zip(rings, recs)]
        lev_y_w[d] = levs[0]
        rec_y_w[d] = recs[0]
        for ci in (0, 1):
            lev_c_w[ci, d] = levs[1 + ci]
            rec_c_w[ci, d] = recs[1 + ci]

    def w2r(o):
        return wave_to_raster(sched, o)

    return {
        "split64": split64,
        "split32": split32,
        "mode64": mode64,
        "modes32": m32z,
        "modes16": m16z,
        "lev_y": w2r(lev_y_w),
        "lev_cb": w2r(lev_c_w[0]),
        "lev_cr": w2r(lev_c_w[1]),
        "recon_y": from_blocks(w2r(rec_y_w), height, width),
        "recon_u": from_blocks(w2r(rec_c_w[0]), height // 2, width // 2),
        "recon_v": from_blocks(w2r(rec_c_w[1]), height // 2, width // 2),
    }



def host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fetch_levels_i32(out):
    """Host int32 level planes (lev_y, lev_cb, lev_cr) from the encode's
    outputs.  Device tensors cross to the host as int8 when every |level|
    is at most 127 (true at streaming QPs: half the int16 bytes), decided
    by one fetched maximum."""
    levs = [out[k] for k in ("lev_y", "lev_cb", "lev_cr")]
    if all(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in levs):
        if int(torch.stack([x.abs().max() for x in levs]).max()) <= 127:
            levs = [x.to(torch.int8) for x in levs]
    return tuple(host(x).astype(np.int32) for x in levs)


def place_quadrants(lev_y, lev_cb, lev_cr):
    """A CU64 leaf's (4, 1024) / (4, 256) z-order TU levels as (64, 64) and
    (32, 32) blocks."""
    ly = np.zeros((64, 64), np.int32)
    lb = np.zeros((32, 32), np.int32)
    lr = np.zeros((32, 32), np.int32)
    for q, (dy, dx) in enumerate(ZO):
        ly[dy * 32:dy * 32 + 32, dx * 32:dx * 32 + 32] = lev_y[q].reshape(32, 32)
        lb[dy * 16:dy * 16 + 16, dx * 16:dx * 16 + 16] = lev_cb[q].reshape(16, 16)
        lr[dy * 16:dy * 16 + 16, dx * 16:dx * 16 + 16] = lev_cr[q].reshape(16, 16)
    return ly, lb, lr


def quad_trees_from_device64(out, width: int, height: int):
    """The reference's cu32-format trees from the CTB64 IDR outputs.

    lev_y (nctb, 4096): z-order 32-quadrants of 1024; within a split
    quadrant, z-order 16-leaves of 256.  Chroma (nctb, 1024) likewise at
    half the block sizes."""
    nctb = (width // 64) * (height // 64)
    s64 = host(out["split64"]).reshape(-1)
    s32 = host(out["split32"]).reshape(nctb, 4)
    m64 = host(out["mode64"]).reshape(-1)
    m32 = host(out["modes32"]).reshape(nctb, 4)
    m16 = host(out["modes16"]).reshape(nctb, 4, 4)
    lev_y, lev_cb, lev_cr = fetch_levels_i32(out)
    lev_y = lev_y.reshape(nctb, 4, 1024)
    lev_cb = lev_cb.reshape(nctb, 4, 256)
    lev_cr = lev_cr.reshape(nctb, 4, 256)
    trees = []
    for i in range(nctb):
        if not s64[i]:
            ly, lb, lr = place_quadrants(lev_y[i], lev_cb[i], lev_cr[i])
            trees.append(dict(size=64, part=0, modes=[int(m64[i])], lev_y=ly, lev_cb=lb,
                              lev_cr=lr))
            continue
        sub32 = []
        for q in range(4):
            if s32[i, q]:
                ly = lev_y[i, q].reshape(4, 16, 16)
                lb = lev_cb[i, q].reshape(4, 8, 8)
                lr = lev_cr[i, q].reshape(4, 8, 8)
                sub32.append(dict(size=32, split=[
                    dict(size=16, part=0, modes=[int(m16[i, q, z])], lev_y=ly[z],
                         lev_cb=lb[z], lev_cr=lr[z]) for z in range(4)]))
            else:
                sub32.append(dict(size=32, part=0, modes=[int(m32[i, q])],
                                  lev_y=lev_y[i, q].reshape(32, 32),
                                  lev_cb=lev_cb[i, q].reshape(16, 16),
                                  lev_cr=lev_cr[i, q].reshape(16, 16)))
        trees.append(dict(size=64, split=sub32))
    return trees
