"""Random-access B-pyramid encoder on the CTB64 quadtree engines
(counterpart of kvazzup_tpu/encoder/ra.py, `QuadRAEncoder`, without a
per-CTU QP map or cu-tree).

Hierarchical mini-GOPs of 4 or 8 pictures with temporal-layer QP
cascading: CTB64 I anchors, P anchors (`frame_inter64`, TMVP against the
previous anchor) and the bi-predictive `frame_b64` wavefront for every B
layer, each with deblocking and SAO as the low-delay path runs them
(`top.deblock_quad`, `top.sao_filter`) and the native quadtree CABAC
writer.

Every slice carries a short-term RPS whose used_by_curr flags keep exactly
the live pyramid references (higher anchors ride along with used = 0 so
that L0[0] / L1[0] stay the two active references).  Intra refreshes inside
the stream are open-GOP I anchors (TRAIL_R I slices, not IDR), so the
trailing Bs keep their past anchor; only the stream start is an IDR.  The
frames left over at the end are coded as a low-delay P tail.

GOP8 decode order per group (a = previous anchor POC):
  P(a+8, ref a) -> B(a+4: a, a+8) -> B(a+2: a, a+4) -> B(a+1: a, a+2)
  -> B(a+3: a+2, a+4) -> B(a+6: a+4, a+8) -> B(a+5: a+4, a+6)
  -> B(a+7: a+6, a+8); layer QPs +0/+1/+3/+4.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import runtime
from ..core.nal import NalType, NalUnit, compose_nal, ebsp_entry_offsets
from ..core.params import (SliceHeader, compose_pps, compose_slice_header, compose_sps,
                           compose_vps)
from ..entropy.quad import (encode_slice_data_b_quad, encode_slice_data_b_quad_wpp,
                            encode_slice_data_intra_quad, encode_slice_data_intra_quad_wpp,
                            encode_slice_data_p_quad, encode_slice_data_p_quad_wpp)
from .frame_b64 import (encode_frame_b64_fast, quad_b64_trees_from_device, quad_b_bs_maps,
                        quad_b_cell_maps)
from .top import (_check_supported, crop_display, deblock_quad, pad_to_coded, quad64_picture,
                  sao_filter, sao_state)

# per step: (display offset, l0 offset, l1 offset or None, layer,
#   ((neg_delta, used), ...), ((pos_delta, used), ...)), the deltas relative
# to the step's own POC
_GOP8 = (
    (8, 0, None, 0, ((-8, 1),), ()),
    (4, 0, 8, 1, ((-4, 1),), ((4, 1),)),
    (2, 0, 4, 2, ((-2, 1),), ((2, 1), (6, 0))),
    (1, 0, 2, 3, ((-1, 1),), ((1, 1), (3, 0), (7, 0))),
    (3, 2, 4, 3, ((-1, 1),), ((1, 1), (5, 0))),
    (6, 4, 8, 2, ((-2, 1),), ((2, 1),)),
    (5, 4, 6, 3, ((-1, 1),), ((1, 1), (3, 0))),
    (7, 6, 8, 3, ((-1, 1),), ((1, 1),)),
)
_GOP4 = (
    (4, 0, None, 0, ((-4, 1),), ()),
    (2, 0, 4, 1, ((-2, 1),), ((2, 1),)),
    (1, 0, 2, 2, ((-1, 1),), ((1, 1), (3, 0))),
    (3, 2, 4, 2, ((-1, 1),), ((1, 1),)),
)
_LAYER_DQP = {4: (0, 1, 2, 2), 8: (0, 1, 3, 4)}
# the reference's calibration knobs; the port runs their defaults only
_KNOBS = ("KVZ_TPU_RA_BLAM", "KVZ_TPU_RA_DQP", "KVZ_TPU_RA_CUTREE")


class QuadRAEncoder:
    """Hierarchical RA encoder (gop 4 / 8) on the CTB64 quadtree path.

    `times` collects one entry per coded picture: its POC, slice kind, the
    number of pictures its device call coded at once, and the device and
    entropy milliseconds (a batched level's device call is shared evenly
    among its pictures)."""

    def __init__(self, cfg, gop_size: int = 8, intra_period: int = 32, cutree=None, *,
                 device):
        if cutree:
            raise NotImplementedError("cu-tree (--cutree) is not ported")
        if os.environ.get("KVZ_TPU_RA_BLAM") or os.environ.get("KVZ_TPU_RA_DQP") or float(
                os.environ.get("KVZ_TPU_RA_CUTREE", "0") or 0):
            raise NotImplementedError(f"the RA calibration knobs ({', '.join(_KNOBS)}) are "
                                      "not ported")
        if cfg.ctb_log2 != 6:
            raise NotImplementedError("quad RA requires ctb_log2 6 (CTB64)")
        _check_supported(cfg)
        if gop_size not in (4, 8):
            raise ValueError("gop_size must be 4 or 8")
        if intra_period % gop_size:
            raise ValueError("intra_period must be a multiple of gop_size")
        need_reorder = 2 if gop_size == 4 else 3
        if cfg.num_reorder_pics < need_reorder or cfg.max_dec_pic_buffering < gop_size // 2 + 2:
            raise ValueError(f"RA gop{gop_size} needs num_reorder_pics >= {need_reorder}, "
                             f"max_dec_pic_buffering >= {gop_size // 2 + 2}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            runtime.require_cuda()
        self.cfg = cfg
        self.gop_size = gop_size
        self.intra_period = intra_period
        self.sched = _GOP8 if gop_size == 8 else _GOP4
        self.dqp = _LAYER_DQP[gop_size]
        self._pending: list = []
        self._anchor_poc = None
        self._dpb: dict = {}  # poc -> (y, u, v) loop-filtered tensors
        self._col: dict = {}  # poc -> TMVP motion store (mv (n16, 2), inter (n16,))
        self._sent_headers = False
        self.times: list = []

    def headers(self) -> bytes:
        cfg = self.cfg
        return b"".join(compose_nal(n) for n in (compose_vps(cfg), compose_sps(cfg),
                                                 compose_pps(cfg)))

    # ------------------------------------------------------------- driving
    def push_frame(self, y, u, v, qp=None, qp_map=None):
        """Returns a list of (poc, annexb_bytes, recon) in decode order
        (empty until a mini-GOP completes)."""
        if qp_map is not None:
            raise NotImplementedError("per-CTU QP maps (cu_qp_delta) are not ported")
        self._pending.append(pad_to_coded(self.cfg, y, u, v))
        if self._anchor_poc is None:
            return [self._code_i(self._pending.pop(0), poc=0, idr=True, qp=qp)]
        if len(self._pending) == self.gop_size:
            return self._code_group(qp)
        return []

    def flush(self, qp=None):
        """Encode the buffered frames as a low-delay P tail."""
        out = []
        poc = self._anchor_poc
        for f in self._pending:
            poc += 1
            out.append(self._code_p(f, poc, ref_poc=poc - 1, layer=0, rps=(((-1, 1),), ()),
                                    qp=qp, tail=True))
        self._pending = []
        return out

    # ------------------------------------------------------------ internals
    def _code_group(self, qp):
        a0 = self._anchor_poc
        frames, self._pending = self._pending, []
        out = []
        for (off, l0, l1, layer, neg, pos) in self.sched:
            f = frames[off - 1]
            poc = a0 + off
            if l1 is None:
                out.append(self._code_anchor(f, poc, a0, layer, (neg, pos), qp))
            else:
                out.append(self._code_b(f, poc, a0 + l0, a0 + l1, layer, (neg, pos), qp))
            self._prune_dpb(poc, (neg, pos))
        self._anchor_poc = a0 + self.gop_size
        return out

    def _code_anchor(self, f, poc, a0, layer, rps, qp):
        if poc % self.intra_period == 0:
            # open-GOP I anchor: retains the previous anchor for this
            # group's trailing Bs (used = 0: no reference lists)
            return self._code_i(f, poc, idr=False, qp=qp, rps=(((-self.gop_size, 0),), ()))
        return self._code_p(f, poc, ref_poc=a0, layer=layer, rps=rps, qp=qp)

    def _layer_qp(self, qp, layer: int) -> int:
        return (self.cfg.qp if qp is None else int(qp)) + self.dqp[layer]

    def _prune_dpb(self, poc, rps):
        keep = {poc} | {poc + d for d, _ in rps[0]} | {poc + d for d, _ in rps[1]}
        for p in [p for p in self._dpb if p not in keep]:
            del self._dpb[p]
            self._col.pop(p, None)

    def _planes(self, f):
        return tuple(torch.as_tensor(np.array(p, dtype=np.uint8), device=self.device) for p in f)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sao(self, f, planes, qp):
        """SAO on the deblocked planes: (planes, its parameters or None)."""
        if not self.cfg.sao_enabled:
            return planes, None
        *planes, params = sao_filter(self.cfg, *f, *planes, qp)
        return tuple(planes), params

    def _rps_fields(self, rps):
        if rps is None:
            return {}
        neg, pos = rps
        return dict(num_negative_pics=len(neg), delta_pocs=tuple(d for d, _ in neg),
                    neg_used=tuple(u for _, u in neg), pos_deltas=tuple(d for d, _ in pos),
                    pos_used=tuple(u for _, u in pos))

    def _emit(self, poc, kind, device_ms, write, sh, planes, params, n_batch=1):
        """Entropy-code a picture (`write(sao)` -> (payload, substream
        lengths or None)), mux its NAL (after the parameter sets, the first
        time) and store it as a reference.  Returns (poc, bytes, recon)."""
        cfg = self.cfg
        t1 = time.perf_counter()
        payload, entry_offsets = write(None if params is None else sao_state(cfg, params))
        if entry_offsets:
            entry_offsets = ebsp_entry_offsets(payload, entry_offsets)
        w = compose_slice_header(cfg, sh, entry_offsets)
        w.write_bytes(payload)
        stream = b""
        if not self._sent_headers:
            stream += self.headers()
            self._sent_headers = True
        stream += compose_nal(NalUnit(sh.nal_type, w.data()))
        recon = tuple(p.cpu().numpy() for p in crop_display(cfg, *planes))
        self._dpb[poc] = planes
        self.times.append({"poc": poc, "kind": kind, "batch": n_batch, "device_ms": device_ms,
                           "entropy_ms": (time.perf_counter() - t1) * 1e3})
        return poc, stream, recon

    def _slice(self, write_plain, write_wpp, trees, qp, **kw):
        cfg = self.cfg

        def write(sao):
            if cfg.wpp:
                return write_wpp(cfg, trees, slice_qp=qp, sao=sao, **kw)
            return write_plain(cfg, trees, slice_qp=qp, sao=sao, **kw), None
        return write

    def _code_i(self, f, poc, idr: bool, qp=None, rps=None):
        cfg = self.cfg
        t0 = time.perf_counter()
        qp = self._layer_qp(qp, 0)
        planes = self._planes(f)
        trees, rec, _ = quad64_picture(cfg, *planes, qp)
        rec, params = self._sao(planes, rec, qp)
        self._sync()
        t1 = time.perf_counter()
        sh = SliceHeader(slice_type=2, qp=qp,
                         nal_type=NalType.IDR_W_RADL if idr else NalType.TRAIL_R,
                         pic_order_cnt_lsb=poc % (1 << cfg.log2_max_poc_lsb),
                         sao_luma=cfg.sao_enabled, sao_chroma=cfg.sao_enabled, tmvp=False,
                         **self._rps_fields(rps))
        out = self._emit(poc, "I", (t1 - t0) * 1e3, self._slice(
            encode_slice_data_intra_quad, encode_slice_data_intra_quad_wpp, trees, qp), sh,
            rec, params)
        self._anchor_poc = poc
        return out

    def _code_p(self, f, poc, ref_poc, layer, rps, qp=None, tail=False):
        cfg = self.cfg
        t0 = time.perf_counter()
        qp = self._layer_qp(qp, layer)
        planes = self._planes(f)
        trees, rec, col = quad64_picture(cfg, *planes, qp, self._dpb[ref_poc],
                                         self._col.get(ref_poc))
        rec, params = self._sao(planes, rec, qp)
        self._sync()
        t1 = time.perf_counter()
        sh = SliceHeader(slice_type=1, qp=qp, nal_type=NalType.TRAIL_R,
                         pic_order_cnt_lsb=poc % (1 << cfg.log2_max_poc_lsb),
                         max_num_merge_cand=cfg.merge_cand, sao_luma=cfg.sao_enabled,
                         sao_chroma=cfg.sao_enabled, **self._rps_fields(rps))
        out = self._emit(poc, "P", (t1 - t0) * 1e3, self._slice(
            encode_slice_data_p_quad, encode_slice_data_p_quad_wpp, trees, qp,
            merge_k=cfg.merge_cand), sh, rec, params)
        if col is not None:
            self._col[poc] = col
        if tail:
            self._prune_dpb(poc, rps)
            self._anchor_poc = poc
        return out

    def _code_b(self, f, poc, p0, p1, layer, rps, qp=None):
        cfg = self.cfg
        t0 = time.perf_counter()
        qp = self._layer_qp(qp, layer)
        planes = self._planes(f)
        out = encode_frame_b64_fast(*planes, *self._dpb[p0], *self._dpb[p1], qp,
                                    (poc - p0, poc - p1), width=cfg.width, height=cfg.height,
                                    merge_cand=cfg.merge_cand, rdoq=cfg.rdoq)
        return self._finish_b(planes, out, poc, qp, rps, t0)

    def _finish_b(self, planes, out, poc, qp, rps, t0, n_batch=1, shared_ms=0.0):
        """Trees, loop filters, entropy and mux of one B picture from its
        `encode_frame_b64_fast` outputs (shared by the level-batched
        encoder, which passes one picture's slice of its outputs and its
        share of the level's device call)."""
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        trees = quad_b64_trees_from_device(out, w, h)
        rec = out["recon_y"], out["recon_u"], out["recon_v"]
        if cfg.deblocking_enabled:  # bS per 4-sample segment, from the 4x4-cell maps
            rec = deblock_quad(cfg, rec, qp, *quad_b_bs_maps(
                trees, *quad_b_cell_maps(trees, w, h, ctb=64), w, h, ctb=64), 4)
        rec, params = self._sao(planes, rec, qp)
        self._sync()
        t1 = time.perf_counter()
        sh = SliceHeader(slice_type=0, qp=qp, nal_type=NalType.TRAIL_R,
                         pic_order_cnt_lsb=poc % (1 << cfg.log2_max_poc_lsb),
                         max_num_merge_cand=cfg.merge_cand, sao_luma=cfg.sao_enabled,
                         sao_chroma=cfg.sao_enabled, tmvp=False, **self._rps_fields(rps))
        return self._emit(poc, "B", shared_ms + (t1 - t0) * 1e3, self._slice(
            encode_slice_data_b_quad, encode_slice_data_b_quad_wpp, trees, qp,
            merge_k=cfg.merge_cand), sh, rec, params, n_batch)
