"""Sample Adaptive Offset (H.265 8.7.3): per-CTB decision and application
(counterpart of kvazzup_tpu/ops/sao.py, unsharded planes).

SAO runs after deblocking and reads only the deblocked picture.  The
decision gathers per-CTB statistics for every edge class and band at once,
picks offsets and classes by the reference's RD estimate, and `sao_apply`
adds each sample's offset from its CTB's parameters.

`sao_apply_planes` is the hand-kernel wrapper: CPU tensors take
`sao_apply_plain` per plane, CUDA tensors launch `kvz_sao_apply`
(`csrc/sao_kernels.cu`, the counterpart of the Pallas `_sao_strip_kernel`)
once for up to three planes, or raise; `sao_apply` is its one-plane form.
`LAUNCHES` counts kernel launches; the plain version never touches it.
Planes are uint8 at bit depth 8 and uint16 at bit depths 9 to 16 (the
reference's bd 10 mode), and need not be CTB multiples.  The sharded-strip
arguments of the reference (`xpad`, `lvalid`, `rvalid`) are not ported and
raise.

Parameter encoding per CTB and component:
  type: 0 = off, 1 = band (BO), 2 = edge (EO)
  aux: EO class (0 = 0deg, 1 = 90deg, 2 = 135deg, 3 = 45deg) or band position
  offsets[4]: per EO category 1..4, or 4 consecutive bands from aux

The decisions compare float32 costs `dist + lam * bits`; the reference's
compiled CPU program contracts each into one fused multiply-add, so the port
evaluates them with `costs.fma`, with lam rounded to float32 once (as a jit
argument is).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import runtime
from .costs import fma

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2
# (hPos0, vPos0, hPos1, vPos1) per EO class: left/right, up/down, diagonals
_EO_DIRS = ((-1, 0, 1, 0), (0, -1, 0, 1), (-1, -1, 1, 1), (1, -1, -1, 1))
_EO_LO = (0, 0, -7, -7)  # signs inferred per category (+, +, -, -)
_EO_HI = (7, 7, 0, 0)

LAUNCHES = {"sao": 0}
# the kernel stages the CTBs a 128 x 32 tile touches, and a thread's 4
# samples share one: ctb a multiple of 4
CTB_STEP = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sao_lambda(qp: int) -> float:
    """The SAO decision's lambda at slice QP `qp` (the decisions round it
    to float32)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


# ---------------------------------------------------------------- decision


def _edge_index_maps(r):
    """(4, H, W) int32 EO category 0..4 of every sample for each class (0 =
    flat, or a neighbour outside the picture).  r: (H, W) int32."""
    h, w = r.shape
    p = F.pad(r, (1, 1, 1, 1))  # the pad value is never used: masked below
    ys = torch.arange(h, device=r.device)[:, None]
    xs = torch.arange(w, device=r.device)[None, :]
    maps = []
    for dx0, dy0, dx1, dy1 in _EO_DIRS:
        n0 = p[1 + dy0:1 + dy0 + h, 1 + dx0:1 + dx0 + w]
        n1 = p[1 + dy1:1 + dy1 + h, 1 + dx1:1 + dx1 + w]
        raw = 2 + torch.sign(r - n0) + torch.sign(r - n1)
        idx = torch.where(raw == 2, 0, torch.where(raw < 2, raw + 1, raw))
        ok = ((xs + dx0 >= 0) & (xs + dx0 < w) & (xs + dx1 >= 0) & (xs + dx1 < w)
              & (ys + dy0 >= 0) & (ys + dy0 < h) & (ys + dy1 >= 0) & (ys + dy1 < h))
        maps.append(torch.where(ok, idx, 0))
    return torch.stack(maps).to(torch.int32)


def _ctb_histogram(bins, diff, nbins: int, ctb: int):
    """Per-CTB sum of `diff` and count of samples for each bin.

    bins: (P, H, W) int in [0, nbins); diff: (H, W).  Returns int32 sums
    and counts of shape (P, nbins, H / ctb, W / ctb).  Integer sums, so
    the order of accumulation does not matter."""
    p, h, w = bins.shape
    cbh, cbw = h // ctb, w // ctb
    dev = bins.device
    cell = ((torch.arange(h, device=dev)[:, None] // ctb) * cbw
            + torch.arange(w, device=dev)[None, :] // ctb)
    plane = torch.arange(p, device=dev)[:, None, None]
    key = ((plane * nbins + bins.long()) * (cbh * cbw) + cell).reshape(-1)
    size = p * nbins * cbh * cbw
    vals = diff.long().expand(bins.shape).reshape(-1)
    sums = torch.zeros(size, dtype=torch.int64, device=dev).index_add_(0, key, vals)
    cnts = torch.bincount(key, minlength=size)
    shape = (p, nbins, cbh, cbw)
    return sums.reshape(shape).to(torch.int32), cnts.reshape(shape).to(torch.int32)


def sao_statistics(orig, rec, *, ctb: int):
    """Per-CTB SAO statistics of one plane (H, W multiples of ctb).

    orig, rec: (H, W) uint8 or int32 (rec = deblocked).  Returns a dict:
      eo_sum / eo_cnt: (4, 4, cbh, cbw) int32  [class, category - 1]
      band_sum / band_cnt: (32, cbh, cbw) int32
    """
    o = orig.to(torch.int32)
    r = rec.to(torch.int32)
    diff = o - r
    eo_sum, eo_cnt = _ctb_histogram(_edge_index_maps(r), diff, 5, ctb)
    # band = r >> 3 at any bit depth, as in the reference (apply uses bd - 5)
    band_sum, band_cnt = _ctb_histogram((r >> 3)[None], diff, 32, ctb)
    return dict(eo_sum=eo_sum[:, 1:].contiguous(), eo_cnt=eo_cnt[:, 1:].contiguous(),
                band_sum=band_sum[0], band_cnt=band_cnt[0])


def _best_offset(ssum, cnt, lo, hi):
    """Distortion-optimal integer offset in [lo, hi] and its distortion
    delta cnt * o^2 - 2 * o * sum (int32; negative is better)."""
    mean = ssum.to(torch.float32) / cnt.clamp(min=1).to(torch.float32)
    o = torch.clamp(torch.round(mean).to(torch.int32), lo, hi)
    # moving toward zero can only help rate: test o and its toward-zero neighbour
    o2 = o - torch.sign(o)
    d1 = cnt * o * o - 2 * o * ssum
    d2 = cnt * o2 * o2 - 2 * o2 * ssum
    better = d2 < d1
    return torch.where(better, o2, o), torch.where(better, d2, d1)


def _eo_offsets(st):
    dev = st["eo_sum"].device
    lo = torch.tensor(_EO_LO, dtype=torch.int32, device=dev)[None, :, None, None]
    hi = torch.tensor(_EO_HI, dtype=torch.int32, device=dev)[None, :, None, None]
    return _best_offset(st["eo_sum"], st["eo_cnt"], lo, hi)  # (4, 4, cbh, cbw)


def _take_class(o, cls):
    """o (4, 4, cbh, cbw) [class, category]; cls (cbh, cbw) -> (cbh, cbw, 4)."""
    idx = cls[None, None].expand((1,) + o.shape[1:])
    return o.gather(0, idx)[0].permute(1, 2, 0).contiguous()


def _band_window(st):
    """Best 4-band window per CTB: (pos, offsets (cbh, cbw, 4), dist int,
    offset bits) with the non-wrapping windows 0..28 only."""
    bo_o, bo_d = _best_offset(st["band_sum"], st["band_cnt"], -7, 7)  # (32, cbh, cbw)
    win_d = bo_d.unfold(0, 4, 1).sum(dim=-1)  # (29, cbh, cbw)
    pos = torch.argmin(win_d, dim=0)
    dist = win_d.gather(0, pos[None])[0]
    idx = pos[None] + torch.arange(4, device=pos.device)[:, None, None]
    off = bo_o.gather(0, idx).permute(1, 2, 0).contiguous()
    bits = (off.abs().sum(dim=-1) + (off != 0).sum(dim=-1)).to(torch.float32)
    return pos, off, dist, bits


def _choose(eo_cost, bo_cost, lam: float):
    t_eo = eo_cost < bo_cost.clamp(max=lam)
    t_bo = (bo_cost < lam) & ~t_eo
    typ = torch.where(t_eo, SAO_EDGE, torch.where(t_bo, SAO_BAND, SAO_OFF)).to(torch.int32)
    return t_eo, t_bo, typ


def sao_decide(orig, rec, lam: float, *, ctb: int):
    """Per-CTB SAO parameters of one plane.

    Returns (type (cbh, cbw), class or band position (cbh, cbw), offsets
    (cbh, cbw, 4), cost (cbh, cbw) float32): the cost is the RD delta
    (<= 0 improves)."""
    lam = float(np.float32(lam))
    st = sao_statistics(orig, rec, ctb=ctb)
    eo_o, eo_d = _eo_offsets(st)
    eo_dist = eo_d.sum(dim=1).to(torch.float32)  # (4, cbh, cbw)
    eo_bits = 4.0 + eo_o.abs().sum(dim=1).to(torch.float32)  # type + class + offsets
    eo_cost = fma(eo_bits, lam, eo_dist)
    best_class = torch.argmin(eo_cost, dim=0)
    best_eo_cost = eo_cost.gather(0, best_class[None])[0]
    best_eo_off = _take_class(eo_o, best_class)

    bo_pos, bo_off, bo_dist, bo_obits = _band_window(st)
    bo_cost = fma(7.0 + bo_obits, lam, bo_dist.to(torch.float32))

    t_eo, t_bo, typ = _choose(best_eo_cost, bo_cost, lam)
    aux = torch.where(t_eo, best_class, bo_pos).to(torch.int32)
    offs = torch.where(t_eo[..., None], best_eo_off,
                       torch.where(t_bo[..., None], bo_off, 0)).to(torch.int32)
    cost = torch.where(t_eo, best_eo_cost, torch.where(t_bo, bo_cost, lam))
    return typ, aux, offs, cost


def sao_decide_chroma(orig_cb, rec_cb, orig_cr, rec_cr, lam: float, *, ctb: int):
    """Joint chroma decision: type and EO class are shared by Cb and Cr
    (coded once); offsets and band positions stay per component.  Returns
    (typ, class_shared, aux_cb, aux_cr, offs_cb, offs_cr)."""
    lam = float(np.float32(lam))
    st_cb = sao_statistics(orig_cb, rec_cb, ctb=ctb)
    st_cr = sao_statistics(orig_cr, rec_cr, ctb=ctb)
    o_cb, d_cb = _eo_offsets(st_cb)
    o_cr, d_cr = _eo_offsets(st_cr)
    eo_dist = (d_cb + d_cr).sum(dim=1).to(torch.float32)
    eo_bits = 4.0 + (o_cb.abs() + o_cr.abs()).sum(dim=1).to(torch.float32)
    eo_cost = fma(eo_bits, lam, eo_dist)
    cls = torch.argmin(eo_cost, dim=0)
    best_eo_cost = eo_cost.gather(0, cls[None])[0]
    eo_off_cb, eo_off_cr = _take_class(o_cb, cls), _take_class(o_cr, cls)

    pos_cb, boff_cb, bd_cb, bb_cb = _band_window(st_cb)
    pos_cr, boff_cr, bd_cr, bb_cr = _band_window(st_cr)
    bo_bits = 2.0 + (5.0 + bb_cb) + (5.0 + bb_cr)
    bo_cost = fma(bo_bits, lam, bd_cb.to(torch.float32) + bd_cr.to(torch.float32))

    t_eo, t_bo, typ = _choose(best_eo_cost, bo_cost, lam)
    aux_cb = torch.where(t_eo, cls, pos_cb).to(torch.int32)
    aux_cr = torch.where(t_eo, cls, pos_cr).to(torch.int32)
    offs_cb = torch.where(t_eo[..., None], eo_off_cb,
                          torch.where(t_bo[..., None], boff_cb, 0)).to(torch.int32)
    offs_cr = torch.where(t_eo[..., None], eo_off_cr,
                          torch.where(t_bo[..., None], boff_cr, 0)).to(torch.int32)
    return typ, cls.to(torch.int32), aux_cb, aux_cr, offs_cb, offs_cr


# --------------------------------------------------------------- application


def _sample_dtype(bd: int):
    if not 8 <= bd <= 16:
        raise ValueError(f"SAO apply takes bit depths 8 to 16, got {bd}")
    return torch.uint8 if bd == 8 else torch.uint16


def sao_apply_plain(rec, typ, aux, offs, *, ctb: int, bd: int = 8):
    """SAO applied to one plane in plain PyTorch (the reference's XLA form,
    unsharded).  rec (H, W) of bit depth bd; typ, aux (cbh, cbw); offs
    (cbh, cbw, 4).  Neighbours are read from `rec` itself, never from the
    output.  Returns uint8 at bd 8, uint16 otherwise."""
    r = rec.to(torch.int32)
    h, w = r.shape
    emaps = _edge_index_maps(r)

    def up(m):
        return m.repeat_interleave(ctb, dim=0).repeat_interleave(ctb, dim=1)[:h, :w]

    typ_px, aux_px = up(typ), up(aux)
    eo_idx = torch.zeros_like(r)
    for k in range(4):
        eo_idx = torch.where(aux_px == k, emaps[k], eo_idx)
    offs_up = [up(offs[..., j]) for j in range(4)]
    cat_off = torch.zeros_like(r)
    for j in range(4):
        cat_off = torch.where(eo_idx == j + 1, offs_up[j], cat_off)
    brel = ((r >> (bd - 5)) - aux_px) & 31  # the band window wraps modulo 32
    bo_val = torch.zeros_like(r)
    for j in range(4):
        bo_val = torch.where(brel == j, offs_up[j], bo_val)
    delta = torch.where(typ_px == SAO_EDGE, cat_off,
                        torch.where(typ_px == SAO_BAND, bo_val, 0))
    return (r + delta).clamp(0, (1 << bd) - 1).to(_sample_dtype(bd))


def _check_plane(rec, typ, aux, offs, ctb: int, name: str, bd: int):
    """Raise unless the plane's operands are what the kernel takes (the
    message names the plane; nothing is formatted when they are)."""
    try:
        runtime.check_operand(rec, "rec", 2, dtype=_sample_dtype(bd))
        if ctb < CTB_STEP or ctb % CTB_STEP:
            raise ValueError(f"SAO apply needs a ctb that is a multiple of {CTB_STEP}, got {ctb}")
        h, w = rec.shape
        cbh, cbw = -(-h // ctb), -(-w // ctb)
        runtime.check_operand(typ, "typ", 2, (cbh, cbw))
        runtime.check_operand(aux, "aux", 2, (cbh, cbw))
        runtime.check_operand(offs, "offs", 3, (cbh, cbw, 4))
    except (TypeError, ValueError) as e:
        raise type(e)(f"{name}: {e}") from None


def sao_apply_planes(planes, bd: int = 8):
    """Apply SAO to up to three planes of bit depth bd in one launch.

    planes: a sequence of (rec, typ, aux, offs, ctb), each as for
    `sao_apply` (the encoder passes luma at the CTB size and Cb, Cr at half
    of it).  Returns the new (H, W) planes, in order: uint8 at bd 8,
    uint16 otherwise."""
    if not 1 <= len(planes) <= 3:
        raise ValueError(f"SAO apply takes 1 to 3 planes, got {len(planes)}")
    names = ("luma", "cb", "cr") if len(planes) == 3 else ("plane",) * len(planes)
    for (rec, typ, aux, offs, ctb), name in zip(planes, names):
        _check_plane(rec, typ, aux, offs, ctb, name, bd)
    if not runtime.kernel_route(*(t for p in planes for t in p[:4])):
        return [sao_apply_plain(rec, typ, aux, offs, ctb=ctb, bd=bd)
                for rec, typ, aux, offs, ctb in planes]
    rec0 = planes[0][0]
    buf = torch.empty(sum(p[0].numel() for p in planes), dtype=rec0.dtype,
                      device=rec0.device).split([p[0].numel() for p in planes])
    outs = [b.view(p[0].shape) for b, p in zip(buf, planes)]
    args = []
    for (rec, typ, aux, offs, ctb), out in zip(planes, outs):
        h, w = rec.shape
        args += [rec.data_ptr(), typ.data_ptr(), aux.data_ptr(), offs.data_ptr(),
                 out.data_ptr(), h, w, ctb, typ.shape[1]]
    args += [None, None, None, None, None, 0, 0, 0, 0] * (3 - len(planes))
    with runtime.on_device(rec0):
        err = runtime.kernel_lib().kvz_sao_apply(*args, len(planes), bd,
                                                 runtime.stream_ptr(rec0))
    runtime.check_launch(err, "sao")
    LAUNCHES["sao"] += 1
    return outs


def sao_apply(rec, typ, aux, offs, *, ctb: int, bd: int = 8, xpad: int = 0,
              lvalid=False, rvalid=False):
    """Apply SAO to one plane: rec (H, W), uint8 at bit depth bd 8 and
    uint16 at 9..16; typ, aux (cbh, cbw) int32; offs (cbh, cbw, 4) int32,
    cbh = ceil(H / ctb), cbw = ceil(W / ctb), ctb a multiple of 4.  Returns
    a new (H, W) tensor of rec's type: a one-plane launch of the kernel of
    `sao_apply_planes`."""
    if xpad or lvalid or rvalid:
        raise NotImplementedError("sharded-strip SAO (xpad, lvalid, rvalid) is not ported")
    return sao_apply_planes([(rec, typ, aux, offs, ctb)], bd)[0]
