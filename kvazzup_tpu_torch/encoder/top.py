"""Encoder top level: frames in, Annex-B bytes out (counterpart of
kvazzup_tpu/encoder/top.py: its CTB16 and CTB64 low-delay branches).

Per frame: device encode (CTB16: IDR `encode_frame_intra_fast`, P
`encode_frame_p_fast`; CTB64: IDR `encode_frame_intra64_fast`, P
`encode_frame_p64_fast`, whose decision trees cross to the host) ->
deblocking (CTB64: bS maps from the trees on the 8-sample grid) -> SAO
decision and application (`--sao`; both read the original frame) -> the
reference picture advances, and with TMVP its motion store (CTB16: per
CTU; CTB64: on the 16x16 grid, from the trees) -> host CABAC (CTB16:
`entropy.slice_data`, the native C writer or its Python tier where SAO
parameters precede each CTU's syntax; CTB64: the native quadtree writer,
`entropy.quad`) -> NAL mux, with WPP entry points when `cfg.wpp`.
Configurations outside those two branches raise NotImplementedError.

Random access at CTB64 (the JAX CLI's `--gop ra --ctu 64`) is ported too:
`encoder/ra.py` `QuadRAEncoder` and `encoder/ra_batch.py`
`QuadRABatchEncoder` code their I and P anchors through `quad64_picture`
and their B pictures through `encoder/frame_b64.py`, with the loop filters
of this module (`deblock_quad`, `sao_filter`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import runtime
from ..core.nal import NalType, NalUnit, compose_nal, ebsp_entry_offsets
from ..core.params import (SliceHeader, StreamConfig, compose_pps, compose_slice_header,
                           compose_sps, compose_vps)
from ..entropy.quad import (encode_slice_data_intra_quad, encode_slice_data_intra_quad_wpp,
                           encode_slice_data_p_quad, encode_slice_data_p_quad_wpp)
from ..entropy.slice_data import (SaoState, encode_slice_data_intra,
                                  encode_slice_data_intra_wpp, encode_slice_data_p,
                                  encode_slice_data_p_wpp)
from ..ops.deblock import compute_bs, deblock_frame
from ..ops.sao import sao_apply_planes, sao_decide, sao_decide_chroma, sao_lambda
from .cu32 import quad_bs_maps
from .frame_inter import CT_INTRA, encode_frame_p_fast
from .frame_inter32 import quad_p_bs_maps, quad_p_cell_maps
from .frame_inter64 import encode_frame_p64_fast, quad_p64_trees_from_device
from .frame_intra import encode_frame_intra_fast
from .frame_intra64 import encode_frame_intra64_fast, quad_trees_from_device64


def pad_to_coded(cfg, y, u, v):
    """Edge-replicate a display-size frame up to the coded (CTB-aligned)
    size; coded-size input passes through."""
    y = np.asarray(y)
    if y.shape == (cfg.height, cfg.width):
        return y, np.asarray(u), np.asarray(v)
    py, px = cfg.height - y.shape[0], cfg.width - y.shape[1]
    return (np.pad(y, ((0, py), (0, px)), mode="edge"),
            np.pad(np.asarray(u), ((0, py // 2), (0, px // 2)), mode="edge"),
            np.pad(np.asarray(v), ((0, py // 2), (0, px // 2)), mode="edge"))


def crop_display(cfg, ry, ru, rv):
    """Crop a coded-size recon to the signalled conformance window."""
    dh, dw = cfg.out_height, cfg.out_width
    return ry[:dh, :dw], ru[:dh // 2, :dw // 2], rv[:dh // 2, :dw // 2]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or a numpy array, as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_supported(cfg: StreamConfig) -> None:
    common = {
        "bit_depth != 8": cfg.bit_depth != 8,
        "tiles": cfg.tile_cols != 1,
        "slices": cfg.slices != 1,
        "cu_qp_delta": cfg.cu_qp_delta,
        "fast_decision off": not cfg.fast_decision,
        "max_transform_hierarchy_depth_intra": cfg.max_transform_hierarchy_depth_intra != 0,
    }
    if cfg.ctb_log2 == 6:
        branch = "CTB64"
        unsupported = {**common,
                       "min_cb_log2 != 3": cfg.min_cb_log2 != 3,
                       "max_tb_log2 != 5": cfg.max_tb_log2 != 5}
    else:
        branch = "CTB16"
        unsupported = {**common,
                       "ctb_log2 not 4 or 6": cfg.ctb_log2 != 4,
                       "min_cb_log2 != 4": cfg.min_cb_log2 != 4}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            "kvazzup_tpu_torch encodes the CTB16 and CTB64 low-delay paths only; "
            f"unsupported at {branch}: {', '.join(bad)}")
    if cfg.sao_enabled and not cfg.wpp and cfg.ctb_log2 == 4:
        raise NotImplementedError("SAO requires cfg.wpp at CTB16 (or the CTB32/64/tiles paths)")
    if not 1 <= cfg.merge_cand <= 5:
        raise ValueError("merge_cand must be in 1..5")
    if cfg.width % cfg.ctb_size or cfg.height % cfg.ctb_size:
        raise ValueError("coded size must be CTB-aligned (use StreamConfig.for_source)")


def quad64_picture(cfg, y, u, v, qp: int, ref=None, col=None):
    """One CTB64 picture's device stage: the I encode (`ref` None) or the P
    encode against the loop-filtered planes `ref`, with TMVP reading `col`
    (the reference picture's motion store on the 16x16 grid; None: all
    intra), its trees on the host, and deblocking on the 8-sample grid with
    the trees' bS maps.  Returns (trees, planes, this picture's motion
    store: None for an I picture or without TMVP)."""
    w, h = cfg.width, cfg.height
    dev = y.device
    if ref is None:
        out = encode_frame_intra64_fast(y, u, v, qp, width=w, height=h, rdoq=cfg.rdoq)
        trees = quad_trees_from_device64(out, w, h)
        col = None

        def bs_maps():  # bS 2 on every CU / TU edge
            return (*quad_bs_maps(trees, w, h, cfg.ctb_log2), 0)
    else:
        tmvp_kw = {}
        if cfg.temporal_mvp:
            n16 = (w // 16) * (h // 16)
            if col is None or col[0].shape[0] != n16:
                col = (torch.zeros((n16, 2), dtype=torch.int32, device=dev),
                       torch.zeros((n16,), dtype=torch.int32, device=dev))
            tmvp_kw = dict(tmvp=True, col_mv=col[0], col_inter=col[1])
        out = encode_frame_p64_fast(y, u, v, *ref, qp, width=w, height=h,
                                    merge_cand=cfg.merge_cand, rdoq=cfg.rdoq, **tmvp_kw)
        trees = quad_p64_trees_from_device(out, w, h)
        cells = (quad_p_cell_maps(trees, w, h, ctb=64)
                 if cfg.temporal_mvp or cfg.deblocking_enabled else None)
        col = None
        if cfg.temporal_mvp:  # the 16x16-compressed store: each cell's top-left 4x4
            mv4, inter4, _ = cells
            col = (torch.as_tensor(np.ascontiguousarray(mv4[::4, ::4].reshape(-1, 2)), device=dev),
                   torch.as_tensor(np.ascontiguousarray(inter4[::4, ::4].reshape(-1)), device=dev))

        def bs_maps():  # per 4-sample segment, from the 4x4-cell maps
            return (*quad_p_bs_maps(trees, *cells, w, h, ctb=64), 4)
    planes = out["recon_y"], out["recon_u"], out["recon_v"]
    if cfg.deblocking_enabled:
        planes = deblock_quad(cfg, planes, qp, *bs_maps())
    return trees, planes, col


def deblock_quad(cfg, planes, qp: int, bs_v, bs_h, bs_rep: int):
    """Deblocking of a quadtree picture on the 8-sample grid with host bS
    maps (bs_rep 0: one bS per 8-sample segment, 4: per 4 samples)."""
    dev = planes[0].device
    return deblock_frame(*planes, qp, spacing=8, bs_v=torch.as_tensor(bs_v, device=dev),
                         bs_h=torch.as_tensor(bs_h, device=dev), chroma_every=2, bs_rep=bs_rep)


def sao_filter(cfg, y, u, v, ry, ru, rv, qp: int):
    """SAO on the deblocked planes: luma decided at the CTB size, Cb and Cr
    jointly at half of it (shared type and class).  Returns the filtered
    planes and the parameters stacked [luma, Cb, Cr] as (typ, aux, offs)
    tensors on the device."""
    ctb = cfg.ctb_size
    lam = sao_lambda(qp)
    t_l, aux_l, off_l, _ = sao_decide(y, ry, lam, ctb=ctb)
    t_c, _cls, aux_cb, aux_cr, off_cb, off_cr = sao_decide_chroma(u, ru, v, rv, lam, ctb=ctb // 2)
    params = (torch.stack([t_l, t_c, t_c]), torch.stack([aux_l, aux_cb, aux_cr]),
              torch.stack([off_l, off_cb, off_cr]))
    ry, ru, rv = sao_apply_planes([
        (ry.contiguous(), t_l, aux_l, off_l, ctb),
        (ru.contiguous(), t_c, aux_cb, off_cb, ctb // 2),
        (rv.contiguous(), t_c, aux_cr, off_cr, ctb // 2)])
    return ry, ru, rv, params


def sao_state(cfg, params):
    """The entropy coder's SaoState of `sao_filter`'s parameters."""
    typ, aux, offs = (_host(t) for t in params)
    return SaoState(cfg.ctbs_w, cfg.ctbs_h, typ=typ, aux=aux, offs=offs)


class Encoder:
    """HEVC encoder: IDR every `intra_period` frames, low-delay P between,
    on the CTB16 grid or the CTB64 quadtree (`cfg.ctb_log2`).

    vps_period: re-send VPS / SPS / PPS every N IDR pictures (0: with the
    first frame only), so that a decoder that joins late can start."""

    def __init__(self, cfg: StreamConfig, intra_period: int = 1, *, device,
                 vps_period: int = 0) -> None:
        _check_supported(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            runtime.require_cuda()
        self.cfg = cfg
        self.intra_period = max(1, intra_period)
        self.vps_period = vps_period
        self._idr_count = 0
        self._frame_count = 0
        self._poc = 0
        self._ref = None  # (y, u, v) uint8 tensors after the loop filter
        # the reference picture's motion for TMVP, (mv (n, 2), inter (n,))
        # int32: per CTU at CTB16 (zeros after an IDR), on the 16x16 grid at
        # CTB64 (None after an IDR)
        self._col = None

    # ---- checkpoint / resume: the DPB, the motion store, the chain counters
    def snapshot(self) -> dict:
        ref = None if self._ref is None else tuple(p.cpu().numpy() for p in self._ref)
        col = None if self._col is None else tuple(p.cpu().numpy() for p in self._col)
        return {"frame_count": self._frame_count, "poc": self._poc,
                "idr_count": self._idr_count, "ref": ref, "col": col}

    def restore(self, snap: dict, device=None) -> None:
        """Resume from a snapshot (this encoder's or the JAX Encoder's)."""
        if device is not None:
            self.device = torch.device(device)
        self._frame_count = snap["frame_count"]
        self._poc = snap["poc"]
        self._idr_count = snap.get("idr_count", 0)
        ref = snap["ref"]
        self._ref = None if ref is None else tuple(
            torch.as_tensor(np.array(p, dtype=np.uint8), device=self.device)
            for p in ref)
        col = snap.get("col")
        self._col = None if col is None else tuple(
            torch.as_tensor(np.array(p, dtype=np.int32), device=self.device) for p in col)

    def headers(self) -> bytes:
        cfg = self.cfg
        return b"".join(compose_nal(n) for n in
                        (compose_vps(cfg), compose_sps(cfg), compose_pps(cfg)))

    def encode_frame(self, y, u, v, qp: int | None = None):
        """Returns (annexb_bytes, recon (y, u, v) numpy)."""
        return self.encode_frame_entropy(self.encode_frame_device(y, u, v, qp))

    def _plane(self, p):
        return torch.as_tensor(np.array(p, dtype=np.uint8), device=self.device)

    def encode_frame_device(self, y, u, v, qp: int | None = None):
        """Device stage: wavefront encode + deblocking; advances the
        reference picture.  Returns a ctx for encode_frame_entropy."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else int(qp)
        if not 0 <= qp <= 51:
            raise ValueError(f"qp must be in 0..51, got {qp}")
        y, u, v = (self._plane(p) for p in pad_to_coded(cfg, y, u, v))
        is_idr = self._frame_count % self.intra_period == 0 or self._ref is None
        if is_idr:
            self._idr_count += 1
        if cfg.ctb_log2 == 6:
            out, (ry, ru, rv) = self._quad64(y, u, v, qp, is_idr)
        else:
            out, (ry, ru, rv) = self._ctb16(y, u, v, qp, is_idr)
        sao = None
        if cfg.sao_enabled:
            ry, ru, rv, sao = sao_filter(cfg, y, u, v, ry, ru, rv, qp)
        first = self._frame_count == 0 or bool(
            is_idr and self.vps_period and (self._idr_count - 1) % self.vps_period == 0)
        self._frame_count += 1
        self._poc = 0 if is_idr else self._poc + 1
        self._ref = (ry, ru, rv)
        kind = ("quad" if is_idr else "quad_p") if cfg.ctb_log2 == 6 else (
            "idr" if is_idr else "p")
        return {"kind": kind, "out": out, "qp": qp,
                "first": first, "poc": self._poc, "sao": sao, "recon": (ry, ru, rv)}

    def _zero_col(self, n: int):
        return (torch.zeros((n, 2), dtype=torch.int32, device=self.device),
                torch.zeros((n,), dtype=torch.int32, device=self.device))

    def _ctb16(self, y, u, v, qp: int, is_idr: bool):
        """CTB16 device encode + deblocking: (outputs, planes)."""
        cfg = self.cfg
        nctu = cfg.ctbs_w * cfg.ctbs_h
        if is_idr:
            out = encode_frame_intra_fast(y, u, v, qp, width=cfg.width, height=cfg.height,
                                          rdoq=cfg.rdoq)
            bs_v = bs_h = None
        else:
            ry, ru, rv = self._ref
            tmvp_kw = {}
            if cfg.temporal_mvp:
                col = self._zero_col(nctu) if self._col is None else self._col
                tmvp_kw = dict(tmvp=True, col_mv=col[0], col_inter=col[1])
            out = encode_frame_p_fast(y, u, v, ry, ru, rv, qp, width=cfg.width,
                                      height=cfg.height, merge_cand=cfg.merge_cand,
                                      rdoq=cfg.rdoq, **tmvp_kw)
            bs_v, bs_h = compute_bs(out["ctype"], (out["lev_y"] != 0).any(dim=2).any(dim=1),
                                    out["mv"], cfg.ctbs_w, cfg.ctbs_h)
        if cfg.temporal_mvp:  # this picture's motion, for the next P's TMVP
            self._col = self._zero_col(nctu) if is_idr else (
                out["mv"], (out["ctype"] != CT_INTRA).to(torch.int32))
        planes = out["recon_y"], out["recon_u"], out["recon_v"]
        if cfg.deblocking_enabled:
            planes = deblock_frame(*planes, qp, spacing=cfg.ctb_size, bs_v=bs_v, bs_h=bs_h)
        return out, planes

    def _quad64(self, y, u, v, qp: int, is_idr: bool):
        """CTB64 device encode and deblocking: ({"trees"}, planes)."""
        trees, planes, self._col = quad64_picture(self.cfg, y, u, v, qp,
                                                  None if is_idr else self._ref, self._col)
        return {"trees": trees}, planes

    def encode_frame_entropy(self, ctx, materialize_recon: bool = True):
        """Host stage: CABAC + NAL mux.  Returns (annexb_bytes, recon): the
        cropped recon as numpy, or with materialize_recon=False as the
        device tensors (no device-to-host copy).  The ctx's arrays may be
        tensors or numpy arrays already fetched to the host."""
        cfg = self.cfg
        out, qp = ctx["out"], ctx["qp"]

        def host(name):
            return _host(out[name])

        sao = None if ctx["sao"] is None else sao_state(cfg, ctx["sao"])
        entry_offsets = None
        if ctx["kind"] == "quad":
            if cfg.wpp:
                payload, entry_offsets = encode_slice_data_intra_quad_wpp(
                    cfg, out["trees"], slice_qp=qp, sao=sao)
            else:
                payload = encode_slice_data_intra_quad(cfg, out["trees"], slice_qp=qp,
                                                       sao=sao)
            sh = SliceHeader(slice_type=2, qp=qp, nal_type=NalType.IDR_W_RADL,
                             sao_luma=cfg.sao_enabled, sao_chroma=cfg.sao_enabled)
        elif ctx["kind"] == "quad_p":
            if cfg.wpp:
                payload, entry_offsets = encode_slice_data_p_quad_wpp(
                    cfg, out["trees"], slice_qp=qp, sao=sao, merge_k=cfg.merge_cand)
            else:
                payload = encode_slice_data_p_quad(cfg, out["trees"], slice_qp=qp,
                                                   sao=sao, merge_k=cfg.merge_cand)
            sh = self._p_header(qp, ctx["poc"])
        elif ctx["kind"] == "idr":
            arrays = (host("mode"), host("lev_y"), host("lev_cb"), host("lev_cr"))
            if cfg.wpp:
                payload, entry_offsets = encode_slice_data_intra_wpp(
                    cfg, *arrays, sao=sao, slice_qp=qp)
            else:
                payload = encode_slice_data_intra(cfg, *arrays, slice_qp=qp)
            sh = SliceHeader(slice_type=2, qp=qp, nal_type=NalType.IDR_W_RADL,
                             sao_luma=cfg.sao_enabled, sao_chroma=cfg.sao_enabled)
        else:
            merge_kw = {}
            if cfg.merge_cand > 1:
                merge_kw = dict(merge_idxs=host("merge_idx"), merge_k=cfg.merge_cand)
            arrays = (host("ctype"), host("intra_mode"), host("mv"), host("mvp_flag"),
                      host("mvd"), host("lev_y"), host("lev_cb"), host("lev_cr"))
            if cfg.wpp:
                payload, entry_offsets = encode_slice_data_p_wpp(
                    cfg, *arrays, slice_qp=qp, sao=sao, **merge_kw)
            else:
                payload = encode_slice_data_p(cfg, *arrays, slice_qp=qp, **merge_kw)
            sh = self._p_header(qp, ctx["poc"])
        if entry_offsets:
            entry_offsets = ebsp_entry_offsets(payload, entry_offsets)
        w = compose_slice_header(cfg, sh, entry_offsets)
        w.write_bytes(payload)
        stream = self.headers() if ctx["first"] else b""
        stream += compose_nal(NalUnit(sh.nal_type, w.data()))
        recon = crop_display(cfg, *ctx["recon"])
        if materialize_recon:
            recon = tuple(_host(p) for p in recon)
        return stream, recon

    def _p_header(self, qp: int, poc: int) -> SliceHeader:
        cfg = self.cfg
        return SliceHeader(
            slice_type=1, qp=qp, nal_type=NalType.TRAIL_R,
            pic_order_cnt_lsb=poc % (1 << cfg.log2_max_poc_lsb),
            num_negative_pics=1, delta_pocs=(-1,),
            max_num_merge_cand=cfg.merge_cand,
            sao_luma=cfg.sao_enabled, sao_chroma=cfg.sao_enabled)
