"""CTB16 IDR encode: dense mode decision + ring-carry wavefront
reconstruction (counterpart of kvazzup_tpu/encoder/frame_intra.py, fast
path only).

`rd_prepass_grid` decides every CTU's intra mode at once from
original-pixel neighbour boundaries (35-mode SATD sweep, MPM bit cost, true
RD over the top 3).  `encode_frame_intra_fast` then walks the row-aligned
wavefront (`wavefront.schedule_r`: wave d holds CTU
(r, d - 2r) in lane r) and reconstructs: predict the chosen mode from the
reconstructed boundary samples of the previous three waves (the "ring"),
then transform, quantize, dequantize, inverse transform and reconstruct
the wave's luma and both chroma planes in one `code_residual_planes` call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tables import CHROMA_QP_TABLE
from ..ops import ctu_kernels as ck
from ..ops import intra as intra_ops
from ..ops.costs import bits_row_sum, fma
from ..ops.hopper_q import code_residual_planes, code_residual_rows
from ..runtime import device_const
from .wavefront import schedule_r

N = 16

# P-prepass candidate modes: planar, DC and every 4th angle
P_PREPASS_MODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34)


def _lambda_f32(qp: int) -> float:
    """sqrt(0.57 * 2^((qp - 12) / 3)) in float32 as the reference's
    compiled program evaluates it: the division by 3 becomes a float32
    multiply by 1/3, and 2^x is rounded once from the exact power."""
    f32 = np.float32
    x = (f32(qp) - f32(12.0)) * (f32(1.0) / f32(3.0))
    return float(np.sqrt(f32(0.57) * f32(2.0 ** float(x))))


LAMBDA = np.array([_lambda_f32(q) for q in range(52)], np.float32)
# lambda * 1024 truncated: the ME cost scale
LAMBDA_X1K = np.array([int(np.float32(x) * np.float32(1024.0)) for x in LAMBDA],
                      np.int32)


def mpm_list(cand_a):
    """8.4.2 most-probable modes for left candidate cand_a (L,) with the
    above candidate fixed to DC (the above CU lies in another CTB row)."""
    a = cand_a.to(torch.int32)
    b = torch.ones_like(a)
    dev = a.device
    small = device_const("mpm_small", lambda: np.array([0, 1, 26]), dev,
                         torch.int32).expand(a.shape[0], 3)
    big = torch.stack([a, 2 + torch.remainder(a + 29, 32), 2 + torch.remainder(a - 2 + 1, 32)], 1)
    equal = torch.where((a < 2)[:, None], small, big)
    m2 = torch.where((a != 0) & (b != 0), 0, torch.where((a != 1) & (b != 1), 1, 26))
    diff = torch.stack([a, b, m2.to(torch.int32)], 1)
    return torch.where((a == b)[:, None], equal, diff)


def mode_bits_table(cand_a, n_modes: int = 35):
    """(L, n_modes) float32 mode signalling cost: 2 bits for MPM0, 3 for
    MPM1/2, 6 otherwise."""
    mpm = mpm_list(cand_a)
    modes = torch.arange(n_modes, dtype=torch.int32, device=cand_a.device)[None]
    is0 = modes == mpm[:, :1]
    is12 = (modes == mpm[:, 1:2]) | (modes == mpm[:, 2:3])
    return torch.where(is0, 2.0, torch.where(is12, 3.0, 6.0)).to(torch.float32)


def to_blocks(img, n: int):
    """(H, W) -> (nctu, n, n) raster block order."""
    h, w = img.shape
    return img.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3).reshape(-1, n, n)


def from_blocks(blocks, height: int, width: int):
    n = blocks.shape[-1]
    return (blocks.reshape(height // n, width // n, n, n).permute(0, 2, 1, 3)
            .reshape(height, width))


def frame_setup(y, u, v, qp: int, nctu: int):
    """Per-CTU qp, chroma qp and lambda rows plus the original blocks."""
    dev = y.device
    qp = int(qp)
    qp_rows = torch.full((nctu,), qp, dtype=torch.int32, device=dev)
    qpc_rows = torch.full((nctu,), int(CHROMA_QP_TABLE[min(max(qp, 0), 57)]),
                          dtype=torch.int32, device=dev)
    lam_rows = torch.full((nctu,), float(LAMBDA[qp]), dtype=torch.float32, device=dev)
    oy = to_blocks(y.to(torch.int32), 16)
    ou = to_blocks(u.to(torch.int32), 8)
    ov = to_blocks(v.to(torch.int32), 8)
    return qp_rows, qpc_rows, lam_rows, oy, ou, ov


def avail_flags(cw: int, ch: int, device):
    """(nctu,) left / above / above-right availability on the CTB grid."""
    r = np.arange(ch)[:, None]
    c = np.arange(cw)[None, :]
    l = np.broadcast_to(c > 0, (ch, cw))
    a = np.broadcast_to(r > 0, (ch, cw))
    tr = a & (c + 1 < cw)
    return tuple(torch.as_tensor(np.ascontiguousarray(f).reshape(-1), device=device)
                 for f in (l, a, tr))


def orig_boundaries(plane, n: int, cw: int, ch: int):
    """(nctu, 4n+1) boundary walks gathered from the ORIGINAL plane
    (arbitrary where unavailable; pair with substitute_refs_ctb)."""
    p = plane.to(torch.int32)
    dev = p.device
    rsel = torch.as_tensor(np.clip(n * np.arange(ch) - 1, 0, None), device=dev)
    csel = torch.as_tensor(np.clip(n * np.arange(cw) - 1, 0, None), device=dev)
    toprows = p[rsel]  # (ch, W): row n*r - 1
    top = toprows.reshape(ch, cw, n)
    tr_cols = torch.arange(n, toprows.shape[1] + n, device=dev).clamp(max=toprows.shape[1] - 1)
    topright = toprows[:, tr_cols].reshape(ch, cw, n)
    left = p[:, csel].reshape(ch, n, cw).permute(0, 2, 1)  # top-down
    corner = toprows[:, csel]
    a_raw = torch.cat([torch.zeros_like(left), left.flip(-1), corner[..., None],
                       top, topright], dim=-1)
    return a_raw.reshape(ch * cw, 4 * n + 1)


def _take(x, idx):
    """x (B, M, ...) rows selected by idx (B, k) along dim 1."""
    ix = idx.long().reshape(idx.shape + (1,) * (x.ndim - 2)).expand(idx.shape + x.shape[2:])
    return x.gather(1, ix)


def mode_sweep(y, oy_flat, lam_rows, cw: int, ch: int, modes=None, log2: int = 4):
    """Orig-boundary intra sweep on the 2^log2 block grid (cw x ch blocks):
    every mode of `modes` (None = all 35) predicted and SATD-costed against
    the original block, plus its MPM bits (the left neighbour's SATD-best
    mode as candidate A).  Returns (preds (nb, M, n^2), satd (nb, M),
    bits (nb, M), cost = satd + lambda * bits (nb, M), mode_map: the M
    mode numbers, or None for all 35)."""
    n = 1 << log2
    fl, fa, ftr = avail_flags(cw, ch, y.device)
    a = intra_ops.substitute_refs_ctb(orig_boundaries(y, n, cw, ch), fl, fa, ftr, n)
    preds = ck.predict_modes_subset_flat(a, log2, True, modes)
    satd = ck.satd_flat(preds, oy_flat[:, None, :], log2).to(torch.float32)
    sel0 = satd.argmin(dim=1)
    mode_map = None if modes is None else torch.as_tensor(
        np.asarray(modes, np.int32), device=y.device)
    mode0 = sel0 if mode_map is None else mode_map[sel0]
    left0 = torch.roll(mode0.reshape(ch, cw), 1, dims=1).reshape(-1)
    bits = mode_bits_table(torch.where(fl, left0, 1))
    if mode_map is not None:
        bits = bits[:, mode_map.long()]
    cost = fma(lam_rows[:, None], bits, satd)
    return preds, satd, bits, cost, mode_map


def rd_prepass_grid(y, oy_flat, qp_rows, lam_rows, *, log2: int, cw: int, ch: int,
                    k: int = 3, sweep=None):
    """Orig-boundary intra mode + RD estimate on the 2^log2 block grid
    (counterpart of the reference's `frame_intra32._rd_prepass_grid`).

    The 35-mode SATD + MPM-bit sweep (`mode_sweep`, or the `sweep` already
    made) ranks the modes; the top k are coded (transform, quant, dequant,
    inverse, recon) and the winner is the least SSE + lambda^2 * (level
    bits + mode bits).  Returns (mode (nb,) int32, its RD cost (nb,)
    float32)."""
    n2 = 1 << (2 * log2)
    if sweep is None:
        sweep = mode_sweep(y, oy_flat, lam_rows, cw, ch, None, log2)
    preds, _, bits, cost, _ = sweep
    # the reference's top_k keeps the lower index first on ties
    cand = torch.sort(cost, dim=1, stable=True).indices[:, :k]
    cand_preds = _take(preds, cand)
    lev, rec = code_residual_rows(oy_flat, cand_preds.reshape(-1, n2), qp_rows, True, log2,
                                  group=k)
    lev, rec = lev.reshape(cand_preds.shape), rec.reshape(cand_preds.shape)
    sse = ((rec - oy_flat[:, None, :]) ** 2).sum(dim=-1, dtype=torch.int32).to(torch.float32)
    lam2 = (lam_rows * lam_rows)[:, None]
    rd = fma(lam2, bits_row_sum(lev) + bits.gather(1, cand), sse)
    best_k = rd.argmin(dim=1)[:, None]
    return cand.gather(1, best_k)[:, 0].to(torch.int32), rd.gather(1, best_k)[:, 0]


def cost_prepass_grid(y, oy_flat, lam_rows, *, log2: int, cw: int, ch: int,
                      modes=P_PREPASS_MODES):
    """P-frame intra estimate over `modes` on the 2^log2 grid: (mode (nb,),
    SATD + bits cost of the chosen mode + lambda * 3)."""
    _, _, _, cost, mode_map = mode_sweep(y, oy_flat, lam_rows, cw, ch, modes, log2)
    sel = cost.argmin(dim=1)
    mode = (sel if mode_map is None else mode_map[sel]).to(torch.int32)
    best = fma(lam_rows, 3.0, cost.gather(1, sel[:, None])[:, 0])
    return mode, best


# ------------------------------------------------------------ wave helpers


def wave_inputs(sched, nctu: int, arrays, frames: int = 1):
    """Gather per-CTU arrays into (n_waves, lanes, ...) wave order.  With
    `frames` > 1 the arrays hold that many pictures' CTUs one after the
    other, and each picture takes its own block of lanes: (n_waves,
    frames * lanes, ...)."""
    idx = np.minimum(sched["idx"], nctu - 1)
    idx = (idx[:, None, :] + nctu * np.arange(frames)[None, :, None]).reshape(idx.shape[0], -1)
    idx_t = torch.as_tensor(idx.reshape(-1), device=arrays[0].device)
    return [a[idx_t].reshape(idx.shape + tuple(a.shape[1:])) for a in arrays]


def wave_to_raster(sched, out, frames: int = 1):
    """(n_waves, lanes, ...) -> (nctu, ...) raster order; with `frames` > 1
    (n_waves, frames * lanes, ...) -> (frames, nctu, ...)."""
    perm = torch.as_tensor(sched["perm"], device=out.device)
    if frames == 1:
        return out.reshape((-1,) + tuple(out.shape[2:]))[perm]
    nw, rest = out.shape[0], tuple(out.shape[2:])
    per = out.reshape((nw, frames, -1) + rest).transpose(0, 1)
    return per.reshape((frames, -1) + rest)[:, perm]


def wave_flags(sched, cw: int, device, frames: int = 1):
    """(n_waves, frames * lanes) left / above / above-right availability."""
    rs, cs = sched["rs"], sched["cs"]
    return tuple(torch.as_tensor(np.tile(f, (1, frames)), device=device) for f in
                 (cs > 0, rs > 0, (rs > 0) & (cs + 1 < cw)))


def _shift_lanes(x, frames: int = 1):
    """Move every lane down by one (lane 0 gets zeros); with `frames` > 1,
    inside each picture's block of lanes, so no row leaks into the next
    picture's first."""
    if frames == 1:
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    g = x.reshape((frames, -1) + tuple(x.shape[1:]))
    return torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1).reshape(x.shape)


def ring_boundary(ring_bot, ring_rcol, n: int):
    """Per-lane raw boundary walks from a 3-wave ring (slot 0 = wave d-1,
    1 = d-2, 2 = d-3).  Lane k holds CTU row k, so `left` is slot 0 as is
    and the `above*` samples are slots 1/0/2 shifted down one lane."""
    left_rev = ring_rcol[0].flip(-1)
    top = _shift_lanes(ring_bot[1])
    topright = _shift_lanes(ring_bot[0])
    corner = _shift_lanes(ring_bot[2])[:, n - 1:n]
    return torch.cat([torch.zeros_like(left_rev), left_rev, corner, top, topright], dim=-1)


def ring_push(ring, rec, n: int):
    """Push a wave's reconstructed blocks (L, n*n) into the ring."""
    rb, rr = ring
    blk = rec.reshape(-1, n, n)
    return (torch.cat([blk[None, :, n - 1, :], rb[:2]], dim=0),
            torch.cat([blk[None, :, :, n - 1], rr[:2]], dim=0))


def ring0(lanes: int, n: int, device):
    z = torch.zeros((3, lanes, n), dtype=torch.int32, device=device)
    return (z, z.clone())


def _select_mode(preds, sel):
    return preds.gather(1, sel.long()[:, None, None].expand(-1, 1, preds.shape[2]))[:, 0]


def encode_frame_intra_fast(y, u, v, qp: int, *, width: int, height: int,
                            rdoq: bool = False):
    """IDR frame: y (H, W), u, v (H/2, W/2) uint8 tensors on one device.
    With `rdoq` the waves quantize by RDOQ at each lane's lambda^2 (the
    mode prepass keeps the deadzone quantizer, as in the reference).

    Returns per-CTU modes and levels (int16) and the reconstruction."""
    dev = y.device
    cw, ch = width // N, height // N
    nctu = cw * ch
    m = N // 2
    sched = schedule_r(cw, ch)
    lanes = sched["lanes"]
    qp_rows, qpc_rows, lam_rows, oy, ou, ov = frame_setup(y, u, v, qp, nctu)
    modes = rd_prepass_grid(y, oy.reshape(nctu, N * N), qp_rows, lam_rows, log2=4,
                            cw=cw, ch=ch)[0]

    oy_w, ou_w, ov_w, mode_w, qp_w, qpc_w, lam_w = wave_inputs(
        sched, nctu, [oy.reshape(nctu, -1), ou.reshape(nctu, -1),
                      ov.reshape(nctu, -1), modes, qp_rows, qpc_rows, lam_rows])
    fl_w, fa_w, ftr_w = wave_flags(sched, cw, dev)
    nw = sched["n_waves"]
    lev_y_w = torch.empty((nw, lanes, N * N), dtype=torch.int16, device=dev)
    lev_c_w = torch.empty((2, nw, lanes, m * m), dtype=torch.int16, device=dev)
    rec_y_w = torch.empty((nw, lanes, N * N), dtype=torch.uint8, device=dev)
    rec_c_w = torch.empty((2, nw, lanes, m * m), dtype=torch.uint8, device=dev)

    ry = ring0(lanes, N, dev)
    rc = [ring0(lanes, m, dev), ring0(lanes, m, dev)]
    for d in range(nw):
        fl, fa, ftr = fl_w[d], fa_w[d], ftr_w[d]
        a_y = intra_ops.substitute_refs_ctb(ring_boundary(*ry, N), fl, fa, ftr, N)
        pred_y = _select_mode(ck.predict_all_modes_flat(a_y, 4, True), mode_w[d])
        preds_c = []
        for ci in (0, 1):
            a_c = intra_ops.substitute_refs_ctb(ring_boundary(*rc[ci], m), fl, fa, ftr, m)
            preds_c.append(_select_mode(ck.predict_all_modes_flat(a_c, 3, False), mode_w[d]))
        (lev_y, rec_y), *chroma = code_residual_planes(
            [(oy_w[d], pred_y, qp_w[d], 4), (ou_w[d], preds_c[0], qpc_w[d], 3),
             (ov_w[d], preds_c[1], qpc_w[d], 3)], True,
            rdoq=rdoq, lam2=lam_w[d] * lam_w[d] if rdoq else None)
        ry = ring_push(ry, rec_y, N)
        lev_y_w[d] = lev_y
        rec_y_w[d] = rec_y
        for ci, (lev_c, rec_c) in enumerate(chroma):
            rc[ci] = ring_push(rc[ci], rec_c, m)
            lev_c_w[ci, d] = lev_c
            rec_c_w[ci, d] = rec_c

    def blk(o, s):
        return wave_to_raster(sched, o).reshape(nctu, s, s)

    return {
        "mode": modes,
        "lev_y": blk(lev_y_w, N),
        "lev_cb": blk(lev_c_w[0], m),
        "lev_cr": blk(lev_c_w[1], m),
        "recon_y": from_blocks(blk(rec_y_w, N), height, width),
        "recon_u": from_blocks(blk(rec_c_w[0], m), height // 2, width // 2),
        "recon_v": from_blocks(blk(rec_c_w[1], m), height // 2, width // 2),
    }
