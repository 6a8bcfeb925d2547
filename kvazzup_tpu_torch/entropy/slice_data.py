"""Slice-data coding for the intra tool-set: CU syntax + end-of-slice.

Encodes/decodes the per-CTU arrays produced/consumed by the device scans
(coding_quadtree -> coding_unit -> transform_tree of 7.3.8, specialized to
CU == CTB with one luma TU).  The residual layer lives in syntax.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.params import StreamConfig
from .cabac import CabacDecoder, CabacEncoder
from .cabac_tables import OFFSETS
from .syntax import decode_residual, encode_residual


def mpm_candidates(cand_a: int, cand_b: int) -> list[int]:
    """8.4.2 MPM list derivation."""
    if cand_a == cand_b:
        if cand_a < 2:
            return [0, 1, 26]
        return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 2 + 1) % 32)]
    third = 0 if (cand_a != 0 and cand_b != 0) else (1 if (cand_a != 1 and cand_b != 1) else 26)
    return [cand_a, cand_b, third]


def _encode_luma_mode(enc: CabacEncoder, mode: int, cand_a: int, cand_b: int) -> None:
    mpm = mpm_candidates(cand_a, cand_b)
    if mode in mpm:
        enc.encode_bin(OFFSETS["prev_intra_luma_pred_flag"], 1)
        idx = mpm.index(mode)
        enc.encode_bypass(1 if idx else 0)
        if idx:
            enc.encode_bypass(idx - 1)
    else:
        enc.encode_bin(OFFSETS["prev_intra_luma_pred_flag"], 0)
        rem = mode
        for c in sorted(mpm, reverse=True):
            if mode > c:
                rem -= 1
        enc.encode_bypass_bits(rem, 5)


def _decode_luma_mode(dec: CabacDecoder, cand_a: int, cand_b: int) -> int:
    mpm = mpm_candidates(cand_a, cand_b)
    if dec.decode_bin(OFFSETS["prev_intra_luma_pred_flag"]):
        idx = 0
        if dec.decode_bypass():
            idx = 1 + dec.decode_bypass()
        return mpm[idx]
    rem = dec.decode_bypass_bits(5)
    for c in sorted(mpm):
        if rem >= c:
            rem += 1
    return rem


def encode_slice_data_intra(
    cfg: StreamConfig,
    modes: np.ndarray,
    lev_y: np.ndarray,
    lev_cb: np.ndarray,
    lev_cr: np.ndarray,
    use_native: bool = True,
    slice_qp: int | None = None,
) -> bytes:
    """CTU raster scan -> CABAC slice payload (v1: CU == CTB == 16).

    Dispatches to the native C codec (kvazzup_tpu/native) when available;
    this Python path is the behavioral reference (tests assert equality).
    slice_qp (default cfg.qp) MUST be the slice header's SliceQpY — CABAC
    context init depends on it (9.3.2.2).
    """
    sq = cfg.qp if slice_qp is None else slice_qp
    if use_native:
        from ..native import encode_slice_data_intra_native

        out = encode_slice_data_intra_native(cfg, modes, lev_y, lev_cb, lev_cr, sq)
        if out is not None:
            return out
    enc = CabacEncoder(init_type=0, slice_qp=sq)
    ctbs_w, ctbs_h = cfg.ctbs_w, cfg.ctbs_h
    nctu = ctbs_w * ctbs_h
    at_min_cb = cfg.ctb_log2 == cfg.min_cb_log2
    for i in range(nctu):
        c = i % ctbs_w
        mode = int(modes[i])
        # CTB == min CB: no split_cu_flag; intra -> part_mode coded
        if at_min_cb:
            enc.encode_bin(OFFSETS["part_mode"], 1)  # PART_2Nx2N
        cand_a = int(modes[i - 1]) if c > 0 else 1
        cand_b = 1  # above CU is in another CTB row
        _encode_luma_mode(enc, mode, cand_a, cand_b)
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)  # derived (DM)

        cbf_cb = 1 if np.any(lev_cb[i]) else 0
        cbf_cr = 1 if np.any(lev_cr[i]) else 0
        cbf_y = 1 if np.any(lev_y[i]) else 0
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)  # trafoDepth == 0
        if cbf_y:
            encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
        if cbf_cb:
            encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    return enc.data()


def encode_slice_data_intra_segments(
    cfg: StreamConfig, modes, lev_y, lev_cb, lev_cr, slice_qp: int, ranges,
):
    """One slice coded as multiple slice SEGMENTS (dependent slices, 7.3.6.1).

    ranges: [(start_ctu, end_ctu), ...].  Each segment gets its own
    byte-aligned payload ending in end_of_slice_segment_flag = 1; CABAC
    contexts carry across segments (9.3.1), prediction availability is
    slice-wide (the caller encodes the picture as one slice).
    Returns list of payload bytes."""
    ctbs_w = cfg.ctbs_w
    at_min_cb = cfg.ctb_log2 == cfg.min_cb_log2
    payloads = []
    ctx = None
    for (st, en) in ranges:
        enc = CabacEncoder(init_type=0, slice_qp=slice_qp, ctx=ctx)
        for i in range(st, en):
            c = i % ctbs_w
            mode = int(modes[i])
            if at_min_cb:
                enc.encode_bin(OFFSETS["part_mode"], 1)
            cand_a = int(modes[i - 1]) if c > 0 else 1
            _encode_luma_mode(enc, mode, cand_a, 1)
            enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
            cbf_cb = 1 if np.any(lev_cb[i]) else 0
            cbf_cr = 1 if np.any(lev_cr[i]) else 0
            cbf_y = 1 if np.any(lev_y[i]) else 0
            enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
            enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
            enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
            if cbf_y:
                encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
            if cbf_cb:
                encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
            if cbf_cr:
                encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)
            enc.encode_terminate(1 if i == en - 1 else 0)
        ctx = enc.ctx  # contexts at segment end seed the next segment
        payloads.append(enc.data())
    return payloads


def encode_slice_data_intra_pcm(
    cfg: StreamConfig, modes, lev_y, lev_cb, lev_cr, pcm_mask,
    orig_y, orig_u, orig_v, slice_qp: int,
) -> bytes:
    """Intra slice data with PCM CUs (7.3.8.7): CTUs in pcm_mask are coded
    as raw 8-bit samples (flush -> aligned samples -> engine re-init with
    carried contexts, 9.3.1); all other CTUs code pcm_flag = 0."""
    ctbs_w = cfg.ctbs_w
    nctu = ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    at_min_cb = cfg.ctb_log2 == cfg.min_cb_log2
    pieces = []
    enc = CabacEncoder(init_type=0, slice_qp=slice_qp)
    for i in range(nctu):
        c = i % ctbs_w
        r = i // ctbs_w
        if at_min_cb:
            enc.encode_bin(OFFSETS["part_mode"], 1)
        if pcm_mask[i]:
            enc.encode_terminate(1)  # pcm_flag
            pieces.append(enc.data())
            y0, x0 = r * n, c * n
            raw = bytearray()
            raw += bytes(np.asarray(orig_y[y0 : y0 + n, x0 : x0 + n],
                                    np.uint8).reshape(-1))
            raw += bytes(np.asarray(orig_u[y0 // 2 : (y0 + n) // 2,
                                           x0 // 2 : (x0 + n) // 2],
                                    np.uint8).reshape(-1))
            raw += bytes(np.asarray(orig_v[y0 // 2 : (y0 + n) // 2,
                                           x0 // 2 : (x0 + n) // 2],
                                    np.uint8).reshape(-1))
            pieces.append(bytes(raw))
            enc = CabacEncoder(init_type=0, slice_qp=slice_qp, ctx=enc.ctx)
        else:
            enc.encode_terminate(0)  # pcm_flag
            mode = int(modes[i])
            cand_a = int(modes[i - 1]) if c > 0 else 1
            _encode_luma_mode(enc, mode, cand_a, 1)
            enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
            cbf_cb = 1 if np.any(lev_cb[i]) else 0
            cbf_cr = 1 if np.any(lev_cr[i]) else 0
            cbf_y = 1 if np.any(lev_y[i]) else 0
            enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
            enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
            enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
            if cbf_y:
                encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
            if cbf_cb:
                encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
            if cbf_cr:
                encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    pieces.append(enc.data())
    return b"".join(pieces)


def decode_slice_data_intra(cfg: StreamConfig, payload: bytes, slice_qp: int, use_native: bool = True):
    """Inverse of encode_slice_data_intra; returns per-CTU arrays."""
    if use_native:
        from ..native import decode_slice_data_intra_native

        out = decode_slice_data_intra_native(cfg, payload, slice_qp)
        if out is not None:
            return out
    dec = CabacDecoder(payload, init_type=0, slice_qp=slice_qp)
    ctbs_w, ctbs_h = cfg.ctbs_w, cfg.ctbs_h
    nctu = ctbs_w * ctbs_h
    n = cfg.ctb_size
    at_min_cb = cfg.ctb_log2 == cfg.min_cb_log2
    modes = np.zeros(nctu, dtype=np.int32)
    lev_y = np.zeros((nctu, n, n), dtype=np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), dtype=np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), dtype=np.int32)
    for i in range(nctu):
        c = i % ctbs_w
        if at_min_cb:
            part = dec.decode_bin(OFFSETS["part_mode"])
            if part != 1:
                raise NotImplementedError("NxN intra partition not supported yet")
        cand_a = int(modes[i - 1]) if c > 0 else 1
        modes[i] = _decode_luma_mode(dec, cand_a, 1)
        chroma_bin = dec.decode_bin(OFFSETS["intra_chroma_pred_mode"])
        if chroma_bin != 0:
            raise NotImplementedError("non-DM chroma mode not supported yet")
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        if cbf_y:
            lev_y[i] = decode_residual(dec, cfg.ctb_log2, 0)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, cfg.ctb_log2 - 1, 2)
        end = dec.decode_terminate()
        expected = 1 if i == nctu - 1 else 0
        if end != expected:
            raise ValueError(f"end_of_slice mismatch at CTU {i}: {end} != {expected}")
    return modes, lev_y, lev_cb, lev_cr


# ---------------------------------------------------------------- P slices

CT_INTRA, CT_MERGE, CT_AMVP, CT_SKIP = 0, 1, 2, 3


def _write_egk(enc: CabacEncoder, v: int, k: int) -> None:
    while v >= (1 << k):
        enc.encode_bypass(1)
        v -= 1 << k
        k += 1
    enc.encode_bypass(0)
    enc.encode_bypass_bits(v, k)


def _read_egk(dec: CabacDecoder, k: int) -> int:
    v = 0
    while dec.decode_bypass():
        v += 1 << k
        k += 1
    return v + dec.decode_bypass_bits(k)


def _encode_mvd(enc: CabacEncoder, mvd_x: int, mvd_y: int) -> None:
    """mvd_coding (7.3.8.9)."""
    base = OFFSETS["abs_mvd_greater_flag"]
    ax, ay = abs(mvd_x), abs(mvd_y)
    enc.encode_bin(base, 1 if ax > 0 else 0)
    enc.encode_bin(base, 1 if ay > 0 else 0)
    if ax > 0:
        enc.encode_bin(base + 1, 1 if ax > 1 else 0)
    if ay > 0:
        enc.encode_bin(base + 1, 1 if ay > 1 else 0)
    for a, v in ((ax, mvd_x), (ay, mvd_y)):
        if a > 0:
            if a > 1:
                _write_egk(enc, a - 2, 1)
            enc.encode_bypass(1 if v < 0 else 0)


def _decode_mvd(dec: CabacDecoder) -> tuple[int, int]:
    base = OFFSETS["abs_mvd_greater_flag"]
    g0x = dec.decode_bin(base)
    g0y = dec.decode_bin(base)
    g1x = dec.decode_bin(base + 1) if g0x else 0
    g1y = dec.decode_bin(base + 1) if g0y else 0
    out = []
    for g0, g1 in ((g0x, g1x), (g0y, g1y)):
        a = 0
        if g0:
            a = 1
            if g1:
                a = 2 + _read_egk(dec, 1)
            if dec.decode_bypass():
                a = -a
        out.append(a)
    return out[0], out[1]


def _merge_first_mv(i, ctbs_w, nctu, inter, mvs, x0t=0, x1t=None):
    """First-available merge candidate (A1, B1, B0, B2; TMVP off) —
    mirrors encoder/frame_inter._first_inter_mv.  x0t/x1t: tile-column
    bounds in CTBs (prediction never crosses a tile boundary)."""
    if x1t is None:
        x1t = ctbs_w
    c = i % ctbs_w
    r = i // ctbs_w
    order = []
    if c > x0t:
        order.append(i - 1)
    if r > 0:
        order.append(i - ctbs_w)
    if r > 0 and c + 1 < x1t:
        order.append(i - ctbs_w + 1)
    if r > 0 and c > x0t:
        order.append(i - ctbs_w - 1)
    for j in order:
        if inter[j]:
            return np.array(mvs[j])
    return np.zeros(2, np.int32)


def _merge_list_np(i, ctbs_w, inter, mvs, k, x0t=0, x1t=None, col=None):
    """Spec merge list on the one-CU-per-CTB grid (8.5.3.2.3): A1, B1
    (pruned vs A1), B0 (pruned vs B1), B2 (if fewer than 4 candidates so
    far, pruned vs A1/B1), temporal (8.5.3.2.8: the bottom-right col PU
    sits in the next CTB row -> unavailable, so center = the collocated
    picture's same-CTU MV; identity scaling in the single-ref low-delay
    chain), zero-MV fill.  A0 (below-left) is never available in CTB
    raster order.  col = (col_mv (nctu,2), col_inter (nctu,)) or None.
    Mirrors the device wave's construction in encoder/frame_inter (and
    generic_inter._merge_list restricted to this toolset)."""
    if x1t is None:
        x1t = ctbs_w
    c = i % ctbs_w
    r = i // ctbs_w

    def nb(j, ok):
        return (int(mvs[j][0]), int(mvs[j][1])) if (ok and inter[j]) else None

    a1 = nb(i - 1, c > x0t)
    b1 = nb(i - ctbs_w, r > 0)
    b0 = nb(i - ctbs_w + 1, r > 0 and c + 1 < x1t)
    b2 = nb(i - ctbs_w - 1, r > 0 and c > x0t)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    if col is not None and col[1][i] and len(cands) < k:
        cands.append((int(col[0][i][0]), int(col[0][i][1])))  # never pruned
    while len(cands) < k:
        cands.append((0, 0))
    return [np.array(cand, np.int32) for cand in cands[:k]]


def _encode_merge_idx(enc, idx: int, k: int) -> None:
    """merge_idx as TR with cMax = k-1: first bin ctx-coded, rest bypass
    (9.3.3.9)."""
    if k <= 1:
        return
    enc.encode_bin(OFFSETS["merge_idx"], 1 if idx > 0 else 0)
    if idx > 0:
        for _ in range(idx - 1):
            enc.encode_bypass(1)
        if idx < k - 1:
            enc.encode_bypass(0)


def _decode_merge_idx(dec, k: int) -> int:
    if k <= 1:
        return 0
    if not dec.decode_bin(OFFSETS["merge_idx"]):
        return 0
    idx = 1
    while idx < k - 1 and dec.decode_bypass():
        idx += 1
    return idx


def _amvp_candidates(i, ctbs_w, inter, mvs, x0t=0, x1t=None, col=None):
    if x1t is None:
        x1t = ctbs_w
    c = i % ctbs_w
    r = i // ctbs_w
    a_ok = c > x0t and inter[i - 1]
    a_mv = np.array(mvs[i - 1]) if a_ok else np.zeros(2, np.int32)
    b_ok, b_mv = False, np.zeros(2, np.int32)
    order = []
    if r > 0 and c + 1 < x1t:
        order.append(i - ctbs_w + 1)
    if r > 0:
        order.append(i - ctbs_w)
    if r > 0 and c > x0t:
        order.append(i - ctbs_w - 1)
    for j in order:
        if inter[j]:
            b_ok, b_mv = True, np.array(mvs[j])
            break
    both = a_ok and b_ok
    same = both and np.array_equal(a_mv, b_mv)
    # 8.5.3.2.6: spatial A, spatial B (pruned vs A), then temporal when
    # fewer than two entries, then zero fill
    t_ok = col is not None and bool(col[1][i])
    t_mv = np.array(col[0][i], np.int32) if t_ok else np.zeros(2, np.int32)
    nspat = int(a_ok) + int(b_ok and not (a_ok and same))
    mvp0 = a_mv if a_ok else (b_mv if b_ok else (t_mv if t_ok else np.zeros(2, np.int32)))
    if nspat == 2:
        mvp1 = b_mv
    elif nspat == 1 and t_ok:
        mvp1 = t_mv
    else:
        mvp1 = np.zeros(2, np.int32)
    return mvp0, mvp1


def encode_slice_data_p(
    cfg: StreamConfig,
    ctype: np.ndarray,
    intra_modes: np.ndarray,
    mvs: np.ndarray,
    mvp_flags: np.ndarray,
    mvds: np.ndarray,
    lev_y: np.ndarray,
    lev_cb: np.ndarray,
    lev_cr: np.ndarray,
    slice_qp: int | None = None,
    merge_idxs: np.ndarray | None = None,
    merge_k: int = 1,
    qp_map=None,
):
    """P-slice CTU syntax (CU == CTB == 16, one ref).  With qp_map the
    per-CTU cu_qp_delta chain rides the raster scan; returns
    (payload, actual_qp) then, plain bytes otherwise."""
    from ..native import encode_slice_native

    if (merge_k == 1 or merge_idxs is not None) and qp_map is None:
        out = encode_slice_native(
            cfg, 1, False,
            dict(ctype=ctype, intra_modes=intra_modes, mvs=mvs, mvp_flags=mvp_flags,
                 mvds=mvds, lev_y=lev_y, lev_cb=lev_cb, lev_cr=lev_cr,
                 merge_idxs=merge_idxs, merge_k=merge_k),
            slice_qp if slice_qp is not None else cfg.qp,
        )
        if out is not None:
            return out[0]
    enc = CabacEncoder(init_type=1, slice_qp=slice_qp if slice_qp is not None else cfg.qp)
    ctbs_w, ctbs_h = cfg.ctbs_w, cfg.ctbs_h
    nctu = ctbs_w * ctbs_h
    sq = slice_qp if slice_qp is not None else cfg.qp
    qs = QpState(sq, qp_map, nctu) if qp_map is not None else None
    skip = np.zeros(nctu, dtype=bool)
    for i in range(nctu):
        _encode_ctu_p_one(enc, cfg, i, skip, ctype, intra_modes, mvs,
                          mvp_flags, mvds, lev_y, lev_cb, lev_cr, qs,
                          merge_idxs=merge_idxs, merge_k=merge_k)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    if qs is not None:
        return enc.data(), qs.actual
    return enc.data()


def decode_slice_data_p(cfg: StreamConfig, payload: bytes, slice_qp: int, use_native: bool = True, merge_k: int = 1, col=None, cu_qp_delta: bool = False):
    """Inverse of encode_slice_data_p; also reconstructs per-CTU MVs.
    With cu_qp_delta the per-CTU actual QP array is appended to the
    returned tuple."""
    if use_native and not cu_qp_delta:
        from ..native import decode_slice_native

        out = decode_slice_native(cfg, 1, False, payload, None, slice_qp,
                                  merge_k=merge_k, col=col)
        if out is not None:
            return (out["ctype"], out["intra_modes"], out["mvs"],
                    out["lev_y"], out["lev_cb"], out["lev_cr"])
    dec = CabacDecoder(payload, init_type=1, slice_qp=slice_qp)
    ctbs_w, ctbs_h = cfg.ctbs_w, cfg.ctbs_h
    nctu = ctbs_w * ctbs_h
    n = cfg.ctb_size
    ctype = np.zeros(nctu, dtype=np.int32)
    intra_modes = np.zeros(nctu, dtype=np.int32)
    mvs = np.zeros((nctu, 2), dtype=np.int32)
    inter = np.zeros(nctu, dtype=bool)
    skip = np.zeros(nctu, dtype=bool)
    lev_y = np.zeros((nctu, n, n), dtype=np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), dtype=np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), dtype=np.int32)
    qs = QpState(slice_qp, np.zeros(nctu), nctu) if cu_qp_delta else None
    for i in range(nctu):
        _decode_ctu_p_one(dec, cfg, i, skip, inter, ctype, intra_modes, mvs,
                          lev_y, lev_cb, lev_cr, qs, merge_k=merge_k, col=col)
        end = dec.decode_terminate()
        if end != (1 if i == nctu - 1 else 0):
            raise ValueError(f"end_of_slice mismatch at CTU {i}")
    if qs is not None:
        return ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr, qs.actual
    return ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr


class QpState:
    """cu_qp_delta coding state: the qPY_PREV prediction chain (8.6.1).

    With quant group == CTB, the left/above-QG predictors always fall
    outside the current CTB, so qPY_PRED == qPY_PREV (the previous QG in
    decoding order; SliceQpY at the start of the slice and — under
    entropy_coding_sync — at the start of each CTB row)."""

    def __init__(self, slice_qp: int, qp_map=None, nctu: int = 0):
        self.enabled = qp_map is not None
        self.slice_qp = slice_qp
        self.map = qp_map
        self.prev = slice_qp
        self.actual = np.full(nctu, slice_qp, np.int32)

    def row_start(self):
        self.prev = self.slice_qp

    def encode(self, enc, i: int, any_cbf: bool) -> None:
        if not self.enabled:
            return
        pred = self.prev
        if any_cbf:
            actual = int(self.map[i])
            _encode_qp_delta(enc, actual - pred)
        else:
            actual = pred
        self.actual[i] = actual
        self.prev = actual

    def decode(self, dec, i: int, any_cbf: bool) -> None:
        if not self.enabled:
            return
        pred = self.prev
        if any_cbf:
            actual = pred + _decode_qp_delta(dec)
        else:
            actual = pred
        self.actual[i] = actual
        self.prev = actual

    # ---- deferred (in-tree-walk) interface for the quadtree writers:
    # the delta must be interleaved at the FIRST transform unit with a
    # coded block flag (7.3.8.10), which only the tree walk knows.
    def begin_ctu(self, i: int) -> None:
        self._i = i
        self._coded = False

    def tu(self, enc) -> None:
        """Call at every TU whose cbf condition holds; codes the delta once."""
        if not self.enabled or self._coded:
            return
        self._coded = True
        actual = int(self.map[self._i])
        _encode_qp_delta(enc, actual - self.prev)
        self.actual[self._i] = actual
        self.prev = actual

    def end_ctu(self) -> None:
        if not self.enabled or self._coded:
            return
        self.actual[self._i] = self.prev  # no coded delta: QP stays predicted


def _encode_qp_delta(enc: CabacEncoder, delta: int) -> None:
    """cu_qp_delta_abs (TR cMax=5 + EG0) + sign (9.3.3.10)."""
    base = OFFSETS["cu_qp_delta_abs"]
    a = abs(delta)
    prefix = min(a, 5)
    for b in range(prefix):
        enc.encode_bin(base + (0 if b == 0 else 1), 1)
    if prefix < 5:
        enc.encode_bin(base + (0 if prefix == 0 else 1), 0)
    else:
        _write_egk(enc, a - 5, 0)
    if a:
        enc.encode_bypass(1 if delta < 0 else 0)


def _decode_qp_delta(dec: CabacDecoder) -> int:
    base = OFFSETS["cu_qp_delta_abs"]
    prefix = 0
    while prefix < 5 and dec.decode_bin(base + (0 if prefix == 0 else 1)):
        prefix += 1
    a = prefix if prefix < 5 else 5 + _read_egk(dec, 0)
    if a and dec.decode_bypass():
        return -a
    return a


# ------------------------------------------------- WPP (entropy sync) mode

def _encode_ctu_i(enc, cfg, i, modes, lev_y, lev_cb, lev_cr, qp_state=None, sao=None):
    """One CTU of I-slice syntax (shared by the raster and WPP loops)."""
    if sao is not None:
        sao.encode(enc, i)
    c = i % cfg.ctbs_w
    if cfg.ctb_log2 == cfg.min_cb_log2:
        enc.encode_bin(OFFSETS["part_mode"], 1)
    cand_a = int(modes[i - 1]) if c > 0 else 1
    _encode_luma_mode(enc, int(modes[i]), cand_a, 1)
    enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
    cbf_cb = 1 if np.any(lev_cb[i]) else 0
    cbf_cr = 1 if np.any(lev_cr[i]) else 0
    cbf_y = 1 if np.any(lev_y[i]) else 0
    enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
    enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
    enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
    if qp_state is not None:
        qp_state.encode(enc, i, bool(cbf_y or cbf_cb or cbf_cr))
    if cbf_y:
        encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
    if cbf_cb:
        encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
    if cbf_cr:
        encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)


def _decode_ctu_i(dec, cfg, i, modes, lev_y, lev_cb, lev_cr, qp_state=None, sao=None):
    if sao is not None:
        sao.decode(dec, i)
    c = i % cfg.ctbs_w
    if cfg.ctb_log2 == cfg.min_cb_log2:
        if dec.decode_bin(OFFSETS["part_mode"]) != 1:
            raise NotImplementedError("NxN intra partition")
    cand_a = int(modes[i - 1]) if c > 0 else 1
    modes[i] = _decode_luma_mode(dec, cand_a, 1)
    if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
        raise NotImplementedError("non-DM chroma")
    cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
    cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
    cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
    if qp_state is not None:
        qp_state.decode(dec, i, bool(cbf_y or cbf_cb or cbf_cr))
    if cbf_y:
        lev_y[i] = decode_residual(dec, cfg.ctb_log2, 0)
    if cbf_cb:
        lev_cb[i] = decode_residual(dec, cfg.ctb_log2 - 1, 1)
    if cbf_cr:
        lev_cr[i] = decode_residual(dec, cfg.ctb_log2 - 1, 2)


def encode_slice_data_wpp(cfg: StreamConfig, ctu_fn, qp_state=None,
                          slice_qp=None) -> tuple:
    """Generic WPP slice-data encoder (entropy_coding_sync, 9.3.1/9.3.2.3).

    ctu_fn(enc, i): encode one CTU's syntax.  Per-row CABAC engines with
    context inheritance from the second CTU of the row above; each row but
    the last terminates with end_of_subset_one_bit + byte alignment.
    Returns (payload bytes, entry_point_offsets list of per-row lengths).
    """
    cw, chh = cfg.ctbs_w, cfg.ctbs_h
    nctu = cw * chh
    payloads = []
    saved_state = None  # ctx after CTU index 1 of the previous row
    for row in range(chh):
        enc = CabacEncoder(init_type=0 if ctu_fn.init_type == 0 else ctu_fn.init_type,
                           slice_qp=cfg.qp if slice_qp is None else slice_qp)
        if row > 0 and cw > 1 and saved_state is not None:
            enc.ctx = saved_state.copy()
        if qp_state is not None:
            qp_state.row_start()
        for c in range(cw):
            i = row * cw + c
            ctu_fn(enc, i)
            if c == 1:
                saved_state = enc.ctx.copy()
            last_in_slice = i == nctu - 1
            enc.encode_terminate(1 if last_in_slice else 0)
            if not last_in_slice and c == cw - 1:
                enc.encode_terminate(1)  # end_of_subset_one_bit (+flush/align)
        payloads.append(enc.data())
    return b"".join(payloads), [len(p) for p in payloads[:-1]]


def decode_slice_data_wpp(cfg: StreamConfig, payload: bytes, entry_offsets, ctu_fn, init_type, slice_qp, qp_state=None, ctu_range=None):
    """Generic WPP slice-data decoder; ctu_fn(dec, i) decodes one CTU.

    ctu_range=(start, end): decode only the CTU-row-aligned slice segment
    [start, end) (multi-slice pictures with entropy_coding_sync)."""
    cw, chh = cfg.ctbs_w, cfg.ctbs_h
    nctu = cw * chh
    start, stop = ctu_range if ctu_range is not None else (0, nctu)
    if start % cw or (stop % cw and stop != nctu):
        raise NotImplementedError("WPP slices must be CTU-row aligned")
    # split payload into per-row substreams
    bounds = [0]
    for off in entry_offsets:
        bounds.append(bounds[-1] + off)
    bounds.append(len(payload))
    saved_state = None
    for ri, row in enumerate(range(start // cw, -(-stop // cw))):
        data = payload[bounds[ri] : bounds[ri + 1]]
        dec = CabacDecoder(data, init_type=init_type, slice_qp=slice_qp)
        if ri > 0 and cw > 1 and saved_state is not None:
            dec.ctx = saved_state.copy()
        if qp_state is not None:
            qp_state.row_start()
        for c in range(cw):
            i = row * cw + c
            if i >= stop:
                break
            ctu_fn(dec, i)
            if c == 1:
                saved_state = dec.ctx.copy()
            end = dec.decode_terminate()
            expected = 1 if i == stop - 1 else 0
            if end != expected:
                raise ValueError(f"end_of_slice mismatch at CTU {i}")
            if i != stop - 1 and c == cw - 1:
                if dec.decode_terminate() != 1:
                    raise ValueError("missing end_of_subset_one_bit")


def encode_slice_data_intra_wpp(cfg, modes, lev_y, lev_cb, lev_cr, use_native: bool = True, qp_map=None, sao=None, slice_qp=None):
    sq = cfg.qp if slice_qp is None else slice_qp
    if use_native and qp_map is None and sao is None:
        from ..native import encode_slice_native

        out = encode_slice_native(
            cfg, 2, True, dict(modes=modes, lev_y=lev_y, lev_cb=lev_cb, lev_cr=lev_cr), sq
        )
        if out is not None:
            return out
    nctu = cfg.ctbs_w * cfg.ctbs_h
    qs = QpState(sq, qp_map, nctu) if qp_map is not None else None

    def fn(enc, i):
        _encode_ctu_i(enc, cfg, i, modes, lev_y, lev_cb, lev_cr, qs, sao)

    fn.init_type = 0
    out = encode_slice_data_wpp(cfg, fn, qs, slice_qp=sq)
    if qs is not None:
        return out[0], out[1], qs.actual
    return out


def decode_slice_data_intra_wpp(cfg, payload, entry_offsets, slice_qp, use_native: bool = True,
                                cu_qp_delta: bool = False, sao=None):
    if use_native and not cu_qp_delta and sao is None:
        from ..native import decode_slice_native

        out = decode_slice_native(cfg, 2, True, payload, entry_offsets, slice_qp)
        if out is not None:
            return out["intra_modes"], out["lev_y"], out["lev_cb"], out["lev_cr"], None
    n = cfg.ctb_size
    nctu = cfg.ctbs_w * cfg.ctbs_h
    modes = np.zeros(nctu, np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    qs = QpState(slice_qp, np.zeros(nctu), nctu) if cu_qp_delta else None

    def fn(dec, i):
        _decode_ctu_i(dec, cfg, i, modes, lev_y, lev_cb, lev_cr, qs, sao)

    decode_slice_data_wpp(cfg, payload, entry_offsets, fn, 0, slice_qp, qs)
    return modes, lev_y, lev_cb, lev_cr, (qs.actual if qs else None)


def _encode_ctu_p_one(enc, cfg, i, skip, ctype, intra_modes, mvs, mvp_flags, mvds, lev_y, lev_cb, lev_cr, qp_state=None, sao=None, x0t=0, merge_idxs=None, merge_k=1):
    """One CTU of P-slice syntax (shared by the raster, WPP and tile loops);
    x0t = tile-column left bound in CTBs (availability stops there);
    merge_k > 1 codes merge_idx (TR) for skip/merge CUs."""
    if sao is not None:
        sao.encode(enc, i)
    ctbs_w = cfg.ctbs_w
    c = i % ctbs_w
    r = i // ctbs_w
    ct = int(ctype[i])
    ctx = 0
    if c > x0t and skip[i - 1]:
        ctx += 1
    if r > 0 and skip[i - ctbs_w]:
        ctx += 1
    is_skip = ct == CT_SKIP
    enc.encode_bin(OFFSETS["cu_skip_flag"] + ctx, 1 if is_skip else 0)
    skip[i] = is_skip
    if is_skip:
        _encode_merge_idx(enc, 0 if merge_idxs is None else int(merge_idxs[i]),
                          merge_k)
        if qp_state is not None:
            qp_state.encode(enc, i, False)
        return
    enc.encode_bin(OFFSETS["pred_mode_flag"], 1 if ct == CT_INTRA else 0)
    if ct == CT_INTRA:
        enc.encode_bin(OFFSETS["part_mode"], 1)
        cand_a = int(intra_modes[i - 1]) if (c > x0t and ctype[i - 1] == CT_INTRA) else 1
        _encode_luma_mode(enc, int(intra_modes[i]), cand_a, 1)
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
    else:
        enc.encode_bin(OFFSETS["part_mode"], 1)
        enc.encode_bin(OFFSETS["merge_flag"], 1 if ct == CT_MERGE else 0)
        if ct == CT_MERGE:
            _encode_merge_idx(
                enc, 0 if merge_idxs is None else int(merge_idxs[i]), merge_k)
        if ct == CT_AMVP:
            _encode_mvd(enc, int(mvds[i][0]), int(mvds[i][1]))
            enc.encode_bin(OFFSETS["mvp_flag"], int(mvp_flags[i]))
    cbf_cb = 1 if np.any(lev_cb[i]) else 0
    cbf_cr = 1 if np.any(lev_cr[i]) else 0
    cbf_y = 1 if np.any(lev_y[i]) else 0
    root_cbf = cbf_y or cbf_cb or cbf_cr
    if ct == CT_AMVP:
        enc.encode_bin(OFFSETS["rqt_root_cbf"], 1 if root_cbf else 0)
    if ct == CT_MERGE:
        assert root_cbf, "zero-residual merge must be coded as skip"
    if ct == CT_INTRA or root_cbf:
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        if ct == CT_INTRA or cbf_cb or cbf_cr:
            enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
        if qp_state is not None:
            qp_state.encode(enc, i, bool(root_cbf))
        if cbf_y:
            encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
        if cbf_cb:
            encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)
    elif qp_state is not None:
        qp_state.encode(enc, i, False)


def encode_slice_data_p_wpp(cfg, ctype, intra_modes, mvs, mvp_flags, mvds, lev_y, lev_cb, lev_cr, slice_qp=None, use_native: bool = True, qp_map=None, sao=None, merge_idxs=None, merge_k=1):
    if use_native and qp_map is None and sao is None:
        from ..native import encode_slice_native

        out = encode_slice_native(
            cfg, 1, True,
            dict(ctype=ctype, intra_modes=intra_modes, mvs=mvs, mvp_flags=mvp_flags,
                 mvds=mvds, lev_y=lev_y, lev_cb=lev_cb, lev_cr=lev_cr,
                 merge_idxs=merge_idxs, merge_k=merge_k),
            slice_qp if slice_qp is not None else cfg.qp,
        )
        if out is not None:
            return out
    nctu = cfg.ctbs_w * cfg.ctbs_h
    skip = np.zeros(nctu, dtype=bool)
    cfg2 = cfg if slice_qp is None else __import__("dataclasses").replace(cfg, qp=slice_qp)
    qs = QpState(cfg2.qp, qp_map, nctu) if qp_map is not None else None

    def fn(enc, i):
        _encode_ctu_p_one(enc, cfg, i, skip, ctype, intra_modes, mvs, mvp_flags, mvds, lev_y, lev_cb, lev_cr, qs, sao, merge_idxs=merge_idxs, merge_k=merge_k)

    fn.init_type = 1
    out = encode_slice_data_wpp(cfg2, fn, qs)
    if qs is not None:
        return out[0], out[1], qs.actual
    return out


def _decode_ctu_p_one(dec, cfg, i, skip, inter, ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr, qp_state=None, sao=None, x0t=0, x1t=None, merge_k=1, col=None):
    if sao is not None:
        sao.decode(dec, i)
    ctbs_w = cfg.ctbs_w
    c = i % ctbs_w
    r = i // ctbs_w
    ctx = 0
    if c > x0t and skip[i - 1]:
        ctx += 1
    if r > 0 and skip[i - ctbs_w]:
        ctx += 1
    if dec.decode_bin(OFFSETS["cu_skip_flag"] + ctx):
        skip[i] = True
        inter[i] = True
        ctype[i] = CT_SKIP
        idx = _decode_merge_idx(dec, merge_k)
        mvs[i] = _merge_list_np(i, ctbs_w, inter, mvs, merge_k, x0t, x1t, col)[idx]
        if qp_state is not None:
            qp_state.decode(dec, i, False)
        return
    if dec.decode_bin(OFFSETS["pred_mode_flag"]):
        ctype[i] = CT_INTRA
        if dec.decode_bin(OFFSETS["part_mode"]) != 1:
            raise NotImplementedError("NxN partition")
        cand_a = int(intra_modes[i - 1]) if (c > x0t and ctype[i - 1] == CT_INTRA) else 1
        intra_modes[i] = _decode_luma_mode(dec, cand_a, 1)
        if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
            raise NotImplementedError("non-DM chroma")
    else:
        inter[i] = True
        if dec.decode_bin(OFFSETS["part_mode"]) != 1:
            raise NotImplementedError("inter partition != 2Nx2N")
        if dec.decode_bin(OFFSETS["merge_flag"]):
            ctype[i] = CT_MERGE
            idx = _decode_merge_idx(dec, merge_k)
            mvs[i] = _merge_list_np(i, ctbs_w, inter, mvs, merge_k, x0t, x1t, col)[idx]
        else:
            ctype[i] = CT_AMVP
            mvd = _decode_mvd(dec)
            flag = dec.decode_bin(OFFSETS["mvp_flag"])
            mvp0, mvp1 = _amvp_candidates(i, ctbs_w, inter, mvs, x0t, x1t, col)
            mvs[i] = (mvp1 if flag else mvp0) + np.array(mvd, np.int32)
    root_cbf = True
    if ctype[i] == CT_AMVP:
        root_cbf = bool(dec.decode_bin(OFFSETS["rqt_root_cbf"]))
    if ctype[i] == CT_INTRA or root_cbf:
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        if ctype[i] == CT_INTRA or cbf_cb or cbf_cr:
            cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        else:
            cbf_y = 1
        if qp_state is not None:
            qp_state.decode(dec, i, bool(cbf_y or cbf_cb or cbf_cr))
        if cbf_y:
            lev_y[i] = decode_residual(dec, cfg.ctb_log2, 0)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, cfg.ctb_log2 - 1, 2)
    elif qp_state is not None:
        qp_state.decode(dec, i, False)


def decode_slice_data_p_wpp(cfg, payload, entry_offsets, slice_qp, use_native: bool = True, cu_qp_delta: bool = False, sao=None, merge_k: int = 1, col=None):
    if use_native and not cu_qp_delta and sao is None:
        from ..native import decode_slice_native

        out = decode_slice_native(cfg, 1, True, payload, entry_offsets, slice_qp,
                                  merge_k=merge_k, col=col)
        if out is not None:
            return (out["ctype"], out["intra_modes"], out["mvs"],
                    out["lev_y"], out["lev_cb"], out["lev_cr"], None)
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    ctype = np.zeros(nctu, np.int32)
    intra_modes = np.zeros(nctu, np.int32)
    mvs = np.zeros((nctu, 2), np.int32)
    inter = np.zeros(nctu, bool)
    skip = np.zeros(nctu, bool)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    qs = QpState(slice_qp, np.zeros(nctu), nctu) if cu_qp_delta else None

    def fn(dec, i):
        _decode_ctu_p_one(dec, cfg, i, skip, inter, ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr, qs, sao, merge_k=merge_k, col=col)

    decode_slice_data_wpp(cfg, payload, entry_offsets, fn, 1, slice_qp, qs)
    return ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr, (qs.actual if qs else None)


def encode_slice_data_intra_qp(cfg, modes, lev_y, lev_cb, lev_cr, qp_map, slice_qp=None):
    """Non-WPP I-slice encode with per-CTB cu_qp_delta; returns
    (payload, actual_qp array)."""
    sq = cfg.qp if slice_qp is None else slice_qp
    nctu = cfg.ctbs_w * cfg.ctbs_h
    qs = QpState(sq, qp_map, nctu)
    enc = CabacEncoder(init_type=0, slice_qp=sq)
    for i in range(nctu):
        _encode_ctu_i(enc, cfg, i, modes, lev_y, lev_cb, lev_cr, qs)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    return enc.data(), qs.actual


def decode_slice_data_intra_qp(cfg, payload, slice_qp):
    """Non-WPP I-slice decode with cu_qp_delta; returns arrays + actual QP."""
    n = cfg.ctb_size
    nctu = cfg.ctbs_w * cfg.ctbs_h
    modes = np.zeros(nctu, np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    qs = QpState(slice_qp, np.zeros(nctu), nctu)
    dec = CabacDecoder(payload, init_type=0, slice_qp=slice_qp)
    for i in range(nctu):
        _decode_ctu_i(dec, cfg, i, modes, lev_y, lev_cb, lev_cr, qs)
        end = dec.decode_terminate()
        if end != (1 if i == nctu - 1 else 0):
            raise ValueError(f"end_of_slice mismatch at CTU {i}")
    return modes, lev_y, lev_cb, lev_cr, qs.actual


# ---------------------------------------------------------------- SAO

class SaoState:
    """Per-CTB SAO parameter coding (7.3.8.3): merge flags + explicit
    params.  Arrays indexed [component][ctb]: component 0 luma, 1 Cb, 2 Cr.
    typ in {0 off, 1 band, 2 edge}; aux = eo_class (shared for chroma) or
    band_position; offs: signed offsets (EO: cat 3/4 stored negative)."""

    def __init__(self, cw: int, chh: int, typ=None, aux=None, offs=None,
                 luma: bool = True, chroma: bool = True):
        self.cw, self.chh = cw, chh
        n = cw * chh
        self.luma, self.chroma = luma, chroma
        self.typ = np.zeros((3, n), np.int32) if typ is None else np.asarray(typ, np.int32).reshape(3, n)
        self.aux = np.zeros((3, n), np.int32) if aux is None else np.asarray(aux, np.int32).reshape(3, n)
        self.offs = np.zeros((3, n, 4), np.int32) if offs is None else np.asarray(offs, np.int32).reshape(3, n, 4)
        self.slice_of = None  # per-CTU slice index (merge unavailability
        # across slice boundaries, 7.3.8.3); None = single slice
        self.tile_of = None  # per-CTU tile index: merge flags are not
        # even CODED across a tile boundary (7.3.8.3 availability)

    def _avail(self, i, j) -> bool:
        if self.slice_of is not None and self.slice_of[j] != self.slice_of[i]:
            return False
        if self.tile_of is not None and self.tile_of[j] != self.tile_of[i]:
            return False
        return True

    def _same(self, i, j) -> bool:
        return (
            np.array_equal(self.typ[:, i], self.typ[:, j])
            and np.array_equal(self.aux[:, i], self.aux[:, j])
            and np.array_equal(self.offs[:, i], self.offs[:, j])
        )

    def _copy(self, dst, src) -> None:
        self.typ[:, dst] = self.typ[:, src]
        self.aux[:, dst] = self.aux[:, src]
        self.offs[:, dst] = self.offs[:, src]

    def encode(self, enc, i: int) -> None:
        c, r = i % self.cw, i // self.cw
        left_ok = c > 0 and self._avail(i, i - 1)
        merge_left = left_ok and self._same(i, i - 1)
        if left_ok:
            enc.encode_bin(OFFSETS["sao_merge_flag"], 1 if merge_left else 0)
        if not merge_left:
            up_ok = r > 0 and self._avail(i, i - self.cw)
            merge_up = up_ok and self._same(i, i - self.cw)
            if up_ok:
                enc.encode_bin(OFFSETS["sao_merge_flag"], 1 if merge_up else 0)
            if not merge_up:
                self._encode_params(enc, i)

    def _encode_params(self, enc, i: int) -> None:
        for cidx in range(3):
            if (cidx == 0 and not self.luma) or (cidx > 0 and not self.chroma):
                continue
            t = int(self.typ[cidx, i])
            if cidx != 2:  # type coded for luma and once for chroma
                enc.encode_bin(OFFSETS["sao_type_idx"], 1 if t else 0)
                if t:
                    enc.encode_bypass(1 if t == 2 else 0)
            if t == 0:
                continue
            offs = self.offs[cidx, i]
            for k in range(4):
                enc_tr = abs(int(offs[k]))
                for b in range(enc_tr):
                    enc.encode_bypass(1)
                if enc_tr < 7:
                    enc.encode_bypass(0)
            if t == 1:  # band: signs + position
                for k in range(4):
                    if offs[k]:
                        enc.encode_bypass(1 if offs[k] < 0 else 0)
                enc.encode_bypass_bits(int(self.aux[cidx, i]), 5)
            elif cidx != 2:  # edge class for luma / once for chroma
                enc.encode_bypass_bits(int(self.aux[cidx, i]), 2)

    def decode(self, dec, i: int) -> None:
        c, r = i % self.cw, i // self.cw
        if c > 0 and self._avail(i, i - 1) and dec.decode_bin(OFFSETS["sao_merge_flag"]):
            self._copy(i, i - 1)
            return
        if r > 0 and self._avail(i, i - self.cw) and dec.decode_bin(OFFSETS["sao_merge_flag"]):
            self._copy(i, i - self.cw)
            return
        for cidx in range(3):
            if (cidx == 0 and not self.luma) or (cidx > 0 and not self.chroma):
                continue
            if cidx != 2:
                t = 0
                if dec.decode_bin(OFFSETS["sao_type_idx"]):
                    t = 2 if dec.decode_bypass() else 1
            else:
                t = int(self.typ[1, i])  # chroma type shared
            self.typ[cidx, i] = t
            if t == 0:
                continue
            absv = []
            for k in range(4):
                v = 0
                while v < 7 and dec.decode_bypass():
                    v += 1
                absv.append(v)
            if t == 1:
                offs = []
                for k in range(4):
                    s = dec.decode_bypass() if absv[k] else 0
                    offs.append(-absv[k] if s else absv[k])
                self.offs[cidx, i] = offs
                self.aux[cidx, i] = dec.decode_bypass_bits(5)
            else:
                self.offs[cidx, i] = [absv[0], absv[1], -absv[2], -absv[3]]
                if cidx != 2:
                    self.aux[cidx, i] = dec.decode_bypass_bits(2)
                else:
                    self.aux[2, i] = self.aux[1, i]  # chroma EO class shared


def derive_qp_actual_tiles(flat_map, any_cbf, cfg, n_cols: int, slice_qp: int):
    """Per-CTU actual QP under the 8.6.1 chain in TILE-raster order
    (qPY_PREV resets to SliceQpY at each tile start).  Matches the tile
    writers' QpState exactly."""
    cw = cfg.ctbs_w
    out = np.zeros(cw * cfg.ctbs_h, np.int32)
    for (x0, x1) in tile_grid(cfg, n_cols):
        prev = slice_qp
        for r in range(cfg.ctbs_h):
            for c in range(x0, x1):
                i = r * cw + c
                out[i] = int(flat_map[i]) if any_cbf[i] else prev
                prev = out[i]
    return out


def derive_qp_actual(flat_map, any_cbf, cw: int, chh: int, slice_qp: int, wpp: bool):
    """Actual per-CTU QP under the qPY_PREV chain (8.6.1): CTUs with no
    coded coefficients inherit the predictor.  Matches QpState exactly."""
    nctu = cw * chh
    out = np.zeros(nctu, np.int32)
    prev = slice_qp
    for i in range(nctu):
        if wpp and i % cw == 0:
            prev = slice_qp
        out[i] = int(flat_map[i]) if any_cbf[i] else prev
        prev = out[i]
    return out


# ---------------------------------------------------------------- B slices

def _scale_mv_np(mv, tb, td):
    """numpy mirror of encoder/frame_b.scale_mv (8.5.3.2.9)."""
    td = int(np.clip(td, -128, 127))
    tb = int(np.clip(tb, -128, 127))
    abs_td = abs(td)
    tx_mag = (16384 + (abs_td >> 1)) // max(abs_td, 1)
    tx = -tx_mag if td < 0 else tx_mag
    dsf = int(np.clip((tb * tx + 32) >> 6, -4096, 4095))
    prod = dsf * np.asarray(mv, np.int64)
    out = np.sign(prod) * ((np.abs(prod) + 127) >> 8)
    return np.clip(out, -32768, 32767).astype(np.int32)


def _amvp_list_b_np(nbs, lx, tb, td_other):
    """numpy mirror of encoder/frame_b._amvp_list_b.

    nbs: [(avail, pf (2,), mv (2,2))] for [left, AR, A, AL]."""
    (l_av, l_pf, l_mv), b_nbs = nbs[0], nbs[1:]
    left_inter = l_av and (l_pf[0] or l_pf[1])

    a_avail = False
    a_mv = np.zeros(2, np.int32)
    if l_av:
        if l_pf[lx]:
            a_avail, a_mv = True, np.array(l_mv[lx])
        elif l_pf[1 - lx]:
            a_avail, a_mv = True, _scale_mv_np(l_mv[1 - lx], tb, td_other)

    b_avail_ns = False
    b_mv_ns = np.zeros(2, np.int32)
    for av, pf, mv in b_nbs:
        if av and pf[lx] and not b_avail_ns:
            b_avail_ns, b_mv_ns = True, np.array(mv[lx])

    b_avail_sc = False
    b_mv_sc = np.zeros(2, np.int32)
    for av, pf, mv in b_nbs:
        if av and (pf[0] or pf[1]) and not b_avail_sc:
            if pf[lx]:
                cand = np.array(mv[lx])
            else:
                cand = _scale_mv_np(mv[1 - lx], tb, td_other)
            b_avail_sc, b_mv_sc = True, cand

    if left_inter:
        fa, fam, fb, fbm = a_avail, a_mv, b_avail_ns, b_mv_ns
    else:
        fa, fam, fb, fbm = b_avail_ns, b_mv_ns, b_avail_sc, b_mv_sc

    both = fa and fb
    same = both and np.array_equal(fam, fbm)
    mvp0 = fam if fa else (fbm if fb else np.zeros(2, np.int32))
    mvp1 = fbm if (both and not same) else np.zeros(2, np.int32)
    return mvp0, mvp1


def _merge_full_motion_np(i, cw, pf_arr, mv_arr, inter):
    """First inter neighbor's full motion (A1,B1,B0,B2) else zero-BI."""
    c, r = i % cw, i // cw
    order = []
    if c > 0:
        order.append(i - 1)
    if r > 0:
        order.append(i - cw)
    if r > 0 and c + 1 < cw:
        order.append(i - cw + 1)
    if r > 0 and c > 0:
        order.append(i - cw - 1)
    for j in order:
        if inter[j]:
            return pf_arr[j].copy(), mv_arr[j].copy()
    return np.array([True, True]), np.zeros((2, 2), np.int32)


def _merge_list_full_np(i, cw, pf_arr, mv_arr, inter, k):
    """Spec merge list with full (bi-pred) motion on the CTB grid: A1, B1
    (pruned vs A1), B0 (pruned vs B1), B2 (pruned vs A1/B1), zero-BI fill.
    Candidate equality compares pred flags and both MVs (8.5.3.2.3)."""
    c, r = i % cw, i // cw

    def nb(j, ok):
        if ok and inter[j]:
            return (tuple(pf_arr[j]), tuple(map(tuple, mv_arr[j])))
        return None

    a1 = nb(i - 1, c > 0)
    b1 = nb(i - cw, r > 0)
    b0 = nb(i - cw + 1, r > 0 and c + 1 < cw)
    b2 = nb(i - cw - 1, r > 0 and c > 0)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    zero = ((True, True), ((0, 0), (0, 0)))
    while len(cands) < k:
        cands.append(zero)
    return [(np.array(pf), np.array(mv, np.int32)) for pf, mv in cands[:k]]


def _amvp_nbs_np(i, cw, pf_arr, mv_arr, inter):
    c, r = i % cw, i // cw

    def nb(j, av):
        if av:
            return (bool(inter[j]), pf_arr[j], mv_arr[j])
        return (False, np.zeros(2, bool), np.zeros((2, 2), np.int32))

    return [
        nb(i - 1, c > 0),
        nb(i - cw + 1, r > 0 and c + 1 < cw),
        nb(i - cw, r > 0),
        nb(i - cw - 1, r > 0 and c > 0),
    ]


def _encode_ctu_b_one(enc, cfg, i, skip, ctype, intra_modes, pf_arr, mv_arr,
                      inter_dirs, mvp_flags, mvds, lev_y, lev_cb, lev_cr,
                      qp_state=None, sao=None, merge_idxs=None, merge_k=1):
    """One CTU of B-slice syntax."""
    if sao is not None:
        sao.encode(enc, i)
    ctbs_w = cfg.ctbs_w
    c, r = i % ctbs_w, i // ctbs_w
    ct = int(ctype[i])
    ctx = 0
    if c > 0 and skip[i - 1]:
        ctx += 1
    if r > 0 and skip[i - ctbs_w]:
        ctx += 1
    is_skip = ct == CT_SKIP
    enc.encode_bin(OFFSETS["cu_skip_flag"] + ctx, 1 if is_skip else 0)
    skip[i] = is_skip
    if is_skip:
        _encode_merge_idx(enc, 0 if merge_idxs is None else int(merge_idxs[i]),
                          merge_k)
        if qp_state is not None:
            qp_state.encode(enc, i, False)
        return
    enc.encode_bin(OFFSETS["pred_mode_flag"], 1 if ct == CT_INTRA else 0)
    if ct == CT_INTRA:
        enc.encode_bin(OFFSETS["part_mode"], 1)
        cand_a = int(intra_modes[i - 1]) if (c > 0 and ctype[i - 1] == CT_INTRA) else 1
        _encode_luma_mode(enc, int(intra_modes[i]), cand_a, 1)
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
    else:
        enc.encode_bin(OFFSETS["part_mode"], 1)
        enc.encode_bin(OFFSETS["merge_flag"], 1 if ct == CT_MERGE else 0)
        if ct == CT_MERGE:
            _encode_merge_idx(
                enc, 0 if merge_idxs is None else int(merge_idxs[i]), merge_k)
        if ct == CT_AMVP:
            d = int(inter_dirs[i])  # 1=L0, 2=L1, 3=BI
            # inter_pred_idc: bin0 ctx CtDepth(0): BI?; else bin ctx 4: L1?
            enc.encode_bin(OFFSETS["inter_pred_idc"], 1 if d == 3 else 0)
            if d != 3:
                enc.encode_bin(OFFSETS["inter_pred_idc"] + 4, 1 if d == 2 else 0)
            if d & 1:
                _encode_mvd(enc, int(mvds[i][0][0]), int(mvds[i][0][1]))
                enc.encode_bin(OFFSETS["mvp_flag"], int(mvp_flags[i][0]))
            if d & 2:
                _encode_mvd(enc, int(mvds[i][1][0]), int(mvds[i][1][1]))
                enc.encode_bin(OFFSETS["mvp_flag"], int(mvp_flags[i][1]))
    cbf_cb = 1 if np.any(lev_cb[i]) else 0
    cbf_cr = 1 if np.any(lev_cr[i]) else 0
    cbf_y = 1 if np.any(lev_y[i]) else 0
    root_cbf = cbf_y or cbf_cb or cbf_cr
    if ct == CT_AMVP:
        enc.encode_bin(OFFSETS["rqt_root_cbf"], 1 if root_cbf else 0)
    if ct == CT_MERGE:
        assert root_cbf, "zero-residual merge must be coded as skip"
    if ct == CT_INTRA or root_cbf:
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        if ct == CT_INTRA or cbf_cb or cbf_cr:
            enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
        if qp_state is not None:
            qp_state.encode(enc, i, bool(root_cbf))
        if cbf_y:
            encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
        if cbf_cb:
            encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)
    elif qp_state is not None:
        qp_state.encode(enc, i, False)


def encode_slice_data_b(cfg, ctype, intra_modes, pf_arr, mv_arr, inter_dirs,
                        mvp_flags, mvds, lev_y, lev_cb, lev_cr, slice_qp=None,
                        sao=None, merge_idxs=None, merge_k=1) -> bytes:
    """B-slice CTU syntax (CU == CTB == 16) as ONE sequential CABAC stream
    — the non-WPP twin of encode_slice_data_b_wpp.  (The RA path used to
    emit WPP row substreams unconditionally; without entropy_coding_sync
    in the PPS a decoder parses them as a continuous stream and desyncs
    at the first row restart — r4 conformance-window tests caught it.)"""
    nctu = cfg.ctbs_w * cfg.ctbs_h
    skip = np.zeros(nctu, dtype=bool)
    sq = slice_qp if slice_qp is not None else cfg.qp
    enc = CabacEncoder(init_type=2, slice_qp=sq)
    for i in range(nctu):
        _encode_ctu_b_one(enc, cfg, i, skip, ctype, intra_modes, pf_arr,
                          mv_arr, inter_dirs, mvp_flags, mvds, lev_y, lev_cb,
                          lev_cr, None, sao, merge_idxs=merge_idxs,
                          merge_k=merge_k)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    return enc.data()


def encode_slice_data_b_wpp(cfg, ctype, intra_modes, pf_arr, mv_arr, inter_dirs,
                            mvp_flags, mvds, lev_y, lev_cb, lev_cr, slice_qp=None,
                            sao=None, merge_idxs=None, merge_k=1):
    nctu = cfg.ctbs_w * cfg.ctbs_h
    skip = np.zeros(nctu, dtype=bool)
    cfg2 = cfg if slice_qp is None else __import__("dataclasses").replace(cfg, qp=slice_qp)

    def fn(enc, i):
        _encode_ctu_b_one(enc, cfg, i, skip, ctype, intra_modes, pf_arr, mv_arr,
                          inter_dirs, mvp_flags, mvds, lev_y, lev_cb, lev_cr, None, sao,
                          merge_idxs=merge_idxs, merge_k=merge_k)

    fn.init_type = 2  # B slice, cabac_init_flag == 0 -> initType 2
    return encode_slice_data_wpp(cfg2, fn)


def _decode_ctu_b_one(dec, cfg, i, skip, inter, ctype, intra_modes, pf_arr, mv_arr,
                      lev_y, lev_cb, lev_cr, poc_diffs, qp_state=None, sao=None,
                      merge_k=1):
    if sao is not None:
        sao.decode(dec, i)
    ctbs_w = cfg.ctbs_w
    c, r = i % ctbs_w, i // ctbs_w
    tb0, tb1 = poc_diffs
    ctx = 0
    if c > 0 and skip[i - 1]:
        ctx += 1
    if r > 0 and skip[i - ctbs_w]:
        ctx += 1
    if dec.decode_bin(OFFSETS["cu_skip_flag"] + ctx):
        skip[i] = True
        inter[i] = True
        ctype[i] = CT_SKIP
        idx = _decode_merge_idx(dec, merge_k)
        pf_arr[i], mv_arr[i] = _merge_list_full_np(
            i, ctbs_w, pf_arr, mv_arr, inter, merge_k)[idx]
        if qp_state is not None:
            qp_state.decode(dec, i, False)
        return
    if dec.decode_bin(OFFSETS["pred_mode_flag"]):
        ctype[i] = CT_INTRA
        if dec.decode_bin(OFFSETS["part_mode"]) != 1:
            raise NotImplementedError("NxN partition")
        cand_a = int(intra_modes[i - 1]) if (c > 0 and ctype[i - 1] == CT_INTRA) else 1
        intra_modes[i] = _decode_luma_mode(dec, cand_a, 1)
        if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
            raise NotImplementedError("non-DM chroma")
    else:
        inter[i] = True
        if dec.decode_bin(OFFSETS["part_mode"]) != 1:
            raise NotImplementedError("inter partition != 2Nx2N")
        if dec.decode_bin(OFFSETS["merge_flag"]):
            ctype[i] = CT_MERGE
            idx = _decode_merge_idx(dec, merge_k)
            pf_arr[i], mv_arr[i] = _merge_list_full_np(
                i, ctbs_w, pf_arr, mv_arr, inter, merge_k)[idx]
        else:
            ctype[i] = CT_AMVP
            if dec.decode_bin(OFFSETS["inter_pred_idc"]):
                d = 3
            else:
                d = 2 if dec.decode_bin(OFFSETS["inter_pred_idc"] + 4) else 1
            nbs = _amvp_nbs_np(i, ctbs_w, pf_arr, mv_arr, inter)
            pf = np.array([bool(d & 1), bool(d & 2)])
            mv = np.zeros((2, 2), np.int32)
            if d & 1:
                mvd = _decode_mvd(dec)
                flag = dec.decode_bin(OFFSETS["mvp_flag"])
                mvp0, mvp1 = _amvp_list_b_np(nbs, 0, tb0, tb1)
                mv[0] = (mvp1 if flag else mvp0) + np.array(mvd, np.int32)
            if d & 2:
                mvd = _decode_mvd(dec)
                flag = dec.decode_bin(OFFSETS["mvp_flag"])
                mvp0, mvp1 = _amvp_list_b_np(nbs, 1, tb1, tb0)
                mv[1] = (mvp1 if flag else mvp0) + np.array(mvd, np.int32)
            pf_arr[i], mv_arr[i] = pf, mv
    root_cbf = True
    if ctype[i] == CT_AMVP:
        root_cbf = bool(dec.decode_bin(OFFSETS["rqt_root_cbf"]))
    if ctype[i] == CT_INTRA or root_cbf:
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        if ctype[i] == CT_INTRA or cbf_cb or cbf_cr:
            cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        else:
            cbf_y = 1
        if qp_state is not None:
            qp_state.decode(dec, i, bool(cbf_y or cbf_cb or cbf_cr))
        if cbf_y:
            lev_y[i] = decode_residual(dec, cfg.ctb_log2, 0)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, cfg.ctb_log2 - 1, 2)
    elif qp_state is not None:
        qp_state.decode(dec, i, False)


def decode_slice_data_b_wpp(cfg, payload, entry_offsets, slice_qp, poc_diffs, sao=None,
                            merge_k=1):
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    ctype = np.zeros(nctu, np.int32)
    intra_modes = np.zeros(nctu, np.int32)
    pf_arr = np.zeros((nctu, 2), bool)
    mv_arr = np.zeros((nctu, 2, 2), np.int32)
    inter = np.zeros(nctu, bool)
    skip = np.zeros(nctu, bool)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)

    def fn(dec, i):
        _decode_ctu_b_one(dec, cfg, i, skip, inter, ctype, intra_modes, pf_arr, mv_arr,
                          lev_y, lev_cb, lev_cr, poc_diffs, None, sao,
                          merge_k=merge_k)

    decode_slice_data_wpp(cfg, payload, entry_offsets, fn, 2, slice_qp, None)
    return ctype, intra_modes, pf_arr, mv_arr, lev_y, lev_cb, lev_cr


# ---------------------------------------------------------------- tiles

def tile_grid(cfg, n_cols: int):
    """Uniform tile-column boundaries in CTUs (PPS uniform_spacing rule)."""
    cw = cfg.ctbs_w
    return [((i * cw) // n_cols, ((i + 1) * cw) // n_cols) for i in range(n_cols)]


def tile_of_map(cfg, n_cols: int) -> np.ndarray:
    """Per-CTU tile index in picture raster (TileId), for availability."""
    cw = cfg.ctbs_w
    row = np.zeros(cw, np.int32)
    for t, (x0, x1) in enumerate(tile_grid(cfg, n_cols)):
        row[x0:x1] = t
    return np.tile(row, cfg.ctbs_h)


def encode_slice_data_tiles(cfg, n_cols: int, ctu_fn, slice_qp=None,
                            qp_state=None) -> tuple:
    """Tile-column slice data: independent CABAC substream per tile
    (contexts re-initialized, no inheritance), CTUs in tile-raster order,
    end_of_subset termination between tiles (7.3.8.1).

    ctu_fn(enc, i, tile_x0, tile_x1): encode CTU with raster index i; the
    tile bounds let CU syntax treat the tile edge as unavailable.
    Returns (payload, entry_point_offsets)."""
    cw, chh = cfg.ctbs_w, cfg.ctbs_h
    cols = tile_grid(cfg, n_cols)
    payloads = []
    last_tile = n_cols - 1
    for t, (x0, x1) in enumerate(cols):
        enc = CabacEncoder(init_type=ctu_fn.init_type,
                           slice_qp=cfg.qp if slice_qp is None else slice_qp)
        if qp_state is not None:
            qp_state.row_start()  # 8.6.1: qPY_PREV = SliceQpY at tile start
        for r in range(chh):
            for c in range(x0, x1):
                i = r * cw + c
                ctu_fn(enc, i, x0, x1)
                last_in_slice = t == last_tile and r == chh - 1 and c == x1 - 1
                enc.encode_terminate(1 if last_in_slice else 0)
                if not last_in_slice and r == chh - 1 and c == x1 - 1:
                    enc.encode_terminate(1)  # end_of_subset_one_bit
        payloads.append(enc.data())
    return b"".join(payloads), [len(p) for p in payloads[:-1]]


def decode_slice_data_tiles(cfg, n_cols: int, payload, entry_offsets, ctu_fn, init_type, slice_qp, qp_state=None):
    cw, chh = cfg.ctbs_w, cfg.ctbs_h
    cols = tile_grid(cfg, n_cols)
    bounds = [0]
    for off in entry_offsets:
        bounds.append(bounds[-1] + off)
    bounds.append(len(payload))
    nctu = cw * chh
    for t, (x0, x1) in enumerate(cols):
        dec = CabacDecoder(payload[bounds[t] : bounds[t + 1]], init_type=init_type,
                           slice_qp=slice_qp)
        if qp_state is not None:
            qp_state.row_start()  # 8.6.1: qPY_PREV = SliceQpY at tile start
        for r in range(chh):
            for c in range(x0, x1):
                i = r * cw + c
                ctu_fn(dec, i, x0, x1)
                last_in_slice = t == len(cols) - 1 and r == chh - 1 and c == x1 - 1
                end = dec.decode_terminate()
                if end != (1 if last_in_slice else 0):
                    raise ValueError(f"end_of_slice mismatch at CTU {i}")
                if not last_in_slice and r == chh - 1 and c == x1 - 1:
                    if dec.decode_terminate() != 1:
                        raise ValueError("missing end_of_subset at tile end")


def _encode_ctu_i_tile(enc, cfg, i, x0t, modes, lev_y, lev_cb, lev_cr,
                       qp_state=None, sao=None):
    """I-slice CTU syntax with tile-left-edge availability."""
    if sao is not None:
        sao.encode(enc, i)
    c = i % cfg.ctbs_w
    if cfg.ctb_log2 == cfg.min_cb_log2:
        enc.encode_bin(OFFSETS["part_mode"], 1)
    cand_a = int(modes[i - 1]) if c > x0t else 1
    _encode_luma_mode(enc, int(modes[i]), cand_a, 1)
    enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
    cbf_cb = 1 if np.any(lev_cb[i]) else 0
    cbf_cr = 1 if np.any(lev_cr[i]) else 0
    cbf_y = 1 if np.any(lev_y[i]) else 0
    enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
    enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
    enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
    if qp_state is not None:
        qp_state.encode(enc, i, bool(cbf_y or cbf_cb or cbf_cr))
    if cbf_y:
        encode_residual(enc, lev_y[i], cfg.ctb_log2, 0)
    if cbf_cb:
        encode_residual(enc, lev_cb[i], cfg.ctb_log2 - 1, 1)
    if cbf_cr:
        encode_residual(enc, lev_cr[i], cfg.ctb_log2 - 1, 2)


def encode_slice_data_intra_tiles(cfg, n_cols, modes, lev_y, lev_cb, lev_cr,
                                  slice_qp=None, qp_map=None, sao=None):
    sq = cfg.qp if slice_qp is None else slice_qp
    nctu = cfg.ctbs_w * cfg.ctbs_h
    qs = QpState(sq, qp_map, nctu) if qp_map is not None else None

    def fn(enc, i, x0t, x1t):
        _encode_ctu_i_tile(enc, cfg, i, x0t, modes, lev_y, lev_cb, lev_cr,
                           qs, sao)

    fn.init_type = 0
    out = encode_slice_data_tiles(cfg, n_cols, fn, slice_qp, qs)
    if qs is not None:
        return out[0], out[1], qs.actual
    return out


def decode_slice_data_intra_tiles(cfg, n_cols, payload, entry_offsets, slice_qp,
                                  cu_qp_delta: bool = False, sao=None):
    n = cfg.ctb_size
    nctu = cfg.ctbs_w * cfg.ctbs_h
    modes = np.zeros(nctu, np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    qs = QpState(slice_qp, np.zeros(nctu), nctu) if cu_qp_delta else None

    def fn(dec, i, x0t, x1t):
        if sao is not None:
            sao.decode(dec, i)
        c = i % cfg.ctbs_w
        if cfg.ctb_log2 == cfg.min_cb_log2:
            if dec.decode_bin(OFFSETS["part_mode"]) != 1:
                raise NotImplementedError("NxN")
        cand_a = int(modes[i - 1]) if c > x0t else 1
        modes[i] = _decode_luma_mode(dec, cand_a, 1)
        if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
            raise NotImplementedError("non-DM chroma")
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        if qs is not None:
            qs.decode(dec, i, bool(cbf_y or cbf_cb or cbf_cr))
        if cbf_y:
            lev_y[i] = decode_residual(dec, cfg.ctb_log2, 0)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, cfg.ctb_log2 - 1, 2)

    decode_slice_data_tiles(cfg, n_cols, payload, entry_offsets, fn, 0,
                            slice_qp, qs)
    if qs is not None:
        return modes, lev_y, lev_cb, lev_cr, qs.actual
    return modes, lev_y, lev_cb, lev_cr


def encode_slice_data_p_tiles(cfg, n_cols, ctype, intra_modes, mvs, mvp_flags,
                              mvds, lev_y, lev_cb, lev_cr, slice_qp=None,
                              merge_idxs=None, merge_k=1, qp_map=None,
                              sao=None):
    """P-slice tile columns: independent CABAC substream per tile with
    tile-local neighbor availability (the MCTS counterpart of the device
    wave's tile-view encode)."""
    sq = cfg.qp if slice_qp is None else slice_qp
    nctu = cfg.ctbs_w * cfg.ctbs_h
    qs = QpState(sq, qp_map, nctu) if qp_map is not None else None
    skip = np.zeros(nctu, dtype=bool)

    def fn(enc, i, x0t, x1t):
        _encode_ctu_p_one(enc, cfg, i, skip, ctype, intra_modes, mvs,
                          mvp_flags, mvds, lev_y, lev_cb, lev_cr, qs, sao,
                          x0t=x0t, merge_idxs=merge_idxs, merge_k=merge_k)

    fn.init_type = 1
    out = encode_slice_data_tiles(cfg, n_cols, fn, slice_qp, qs)
    if qs is not None:
        return out[0], out[1], qs.actual
    return out


def decode_slice_data_p_tiles(cfg, n_cols, payload, entry_offsets, slice_qp,
                              merge_k: int = 1, cu_qp_delta: bool = False,
                              sao=None, col=None):
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    ctype = np.zeros(nctu, np.int32)
    intra_modes = np.zeros(nctu, np.int32)
    mvs = np.zeros((nctu, 2), np.int32)
    inter = np.zeros(nctu, bool)
    skip = np.zeros(nctu, bool)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    qs = QpState(slice_qp, np.zeros(nctu), nctu) if cu_qp_delta else None

    def fn(dec, i, x0t, x1t):
        _decode_ctu_p_one(dec, cfg, i, skip, inter, ctype, intra_modes, mvs,
                          lev_y, lev_cb, lev_cr, qs, sao, x0t=x0t, x1t=x1t,
                          merge_k=merge_k, col=col)

    decode_slice_data_tiles(cfg, n_cols, payload, entry_offsets, fn, 1,
                            slice_qp, qs)
    if qs is not None:
        return ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr, qs.actual
    return ctype, intra_modes, mvs, lev_y, lev_cb, lev_cr


def decode_slice_data_intra_open(cfg: StreamConfig, payload: bytes, slice_qp: int,
                                 max_ctus: int):
    """Decode I-CTUs until end_of_slice_segment_flag == 1 (7.3.8.1) — the
    slice's own length signal — instead of a caller-assumed count.  This is
    the loss-tolerant path for multi-slice pictures: when a neighbor slice
    NAL is missing, each surviving slice still knows where it ends.

    Returns (modes, lev_y, lev_cb, lev_cr, n_decoded), arrays sized for
    max_ctus."""
    dec = CabacDecoder(payload, init_type=0, slice_qp=slice_qp)
    n = cfg.ctb_size
    at_min_cb = cfg.ctb_log2 == cfg.min_cb_log2
    cw = cfg.ctbs_w
    modes = np.zeros(max_ctus, dtype=np.int32)
    lev_y = np.zeros((max_ctus, n, n), dtype=np.int32)
    lev_cb = np.zeros((max_ctus, n // 2, n // 2), dtype=np.int32)
    lev_cr = np.zeros((max_ctus, n // 2, n // 2), dtype=np.int32)
    for i in range(max_ctus):
        c = i % cw
        if at_min_cb:
            if dec.decode_bin(OFFSETS["part_mode"]) != 1:
                raise NotImplementedError("NxN")
        cand_a = int(modes[i - 1]) if c > 0 else 1
        modes[i] = _decode_luma_mode(dec, cand_a, 1)
        if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
            raise NotImplementedError("non-DM chroma")
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        if cbf_y:
            lev_y[i] = decode_residual(dec, cfg.ctb_log2, 0)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, cfg.ctb_log2 - 1, 1)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, cfg.ctb_log2 - 1, 2)
        if dec.decode_terminate():
            return modes, lev_y, lev_cb, lev_cr, i + 1
    return modes, lev_y, lev_cb, lev_cr, max_ctus


# ------------------------------------------------------- CU quadtree (CU8)

def _quad(a: np.ndarray, k: int) -> np.ndarray:
    """Z-order quadrant k of a square block array."""
    h = a.shape[0] // 2
    r, c = (0, 0) if k == 0 else (0, h) if k == 1 else (h, 0) if k == 2 else (h, h)
    return a[r : r + h, c : c + h]


# per-sub-CU MPM neighbors inside a CTB (z-order): (left source, above source)
# where 'L1'/'L3' = left CTB sub 1/3, 'S<k>' = this CTB's sub k, None = DC
_CU8_NEIGH = [("L1", None), ("S0", None), ("L3", "S0"), ("S2", "S1")]


def _cu8_cands(modes8: np.ndarray, i: int, k: int, c: int) -> tuple:
    ls, as_ = _CU8_NEIGH[k]
    if ls.startswith("L"):
        cand_a = int(modes8[i - 1][int(ls[1])]) if c > 0 else 1
    else:
        cand_a = int(modes8[i][int(ls[1])])
    cand_b = 1 if as_ is None else int(modes8[i][int(as_[1])])
    return cand_a, cand_b


def _encode_ctu_i_cu8(enc, cfg, i, split, modes8, lev_y, lev_cb, lev_cr) -> None:
    """I-CTU with one quadtree level: CTB16 either one CU16 or four CU8s
    (coding_quadtree 7.3.8.4 with MinCbLog2SizeY = 3).

    modes8: (nctu, 4) z-order luma modes (non-split CTBs replicate their
    single mode); lev_y (nctu,16,16) holds four 8x8 quadrants when split;
    lev_cb/lev_cr (nctu,8,8) hold four 4x4 quadrants when split."""
    from ..core.tables import residual_scan_idx

    cw = cfg.ctbs_w
    r, c = divmod(i, cw)
    ctx = (1 if (c > 0 and split[i - 1]) else 0) + (
        1 if (r > 0 and split[i - cw]) else 0
    )
    enc.encode_bin(OFFSETS["split_cu_flag"] + ctx, int(split[i]))
    if not split[i]:
        cand_a = int(modes8[i - 1][1]) if c > 0 else 1
        _encode_luma_mode(enc, int(modes8[i][0]), cand_a, 1)
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
        cbf_cb = 1 if np.any(lev_cb[i]) else 0
        cbf_cr = 1 if np.any(lev_cr[i]) else 0
        cbf_y = 1 if np.any(lev_y[i]) else 0
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
        if cbf_y:
            encode_residual(enc, lev_y[i], 4, 0)
        if cbf_cb:
            encode_residual(enc, lev_cb[i], 3, 1)
        if cbf_cr:
            encode_residual(enc, lev_cr[i], 3, 2)
        return
    for k in range(4):
        mode = int(modes8[i][k])
        cand_a, cand_b = _cu8_cands(modes8, i, k, c)
        enc.encode_bin(OFFSETS["part_mode"], 1)  # PART_2Nx2N at min CB
        _encode_luma_mode(enc, mode, cand_a, cand_b)
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
        qy = _quad(lev_y[i], k)
        qcb = _quad(lev_cb[i], k)
        qcr = _quad(lev_cr[i], k)
        cbf_cb = 1 if np.any(qcb) else 0
        cbf_cr = 1 if np.any(qcr) else 0
        cbf_y = 1 if np.any(qy) else 0
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
        if cbf_y:
            encode_residual(enc, qy, 3, 0, residual_scan_idx(mode, 3, 0))
        if cbf_cb:
            encode_residual(enc, qcb, 2, 1, residual_scan_idx(mode, 2, 1))
        if cbf_cr:
            encode_residual(enc, qcr, 2, 2, residual_scan_idx(mode, 2, 2))


def _decode_ctu_i_cu8(dec, cfg, i, split, modes8, lev_y, lev_cb, lev_cr) -> None:
    from ..core.tables import residual_scan_idx

    cw = cfg.ctbs_w
    r, c = divmod(i, cw)
    ctx = (1 if (c > 0 and split[i - 1]) else 0) + (
        1 if (r > 0 and split[i - cw]) else 0
    )
    split[i] = dec.decode_bin(OFFSETS["split_cu_flag"] + ctx)
    if not split[i]:
        cand_a = int(modes8[i - 1][1]) if c > 0 else 1
        modes8[i][:] = _decode_luma_mode(dec, cand_a, 1)
        if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
            raise NotImplementedError("non-DM chroma")
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        if cbf_y:
            lev_y[i] = decode_residual(dec, 4, 0)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, 3, 1)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, 3, 2)
        return
    for k in range(4):
        if dec.decode_bin(OFFSETS["part_mode"]) != 1:
            raise NotImplementedError("NxN")
        cand_a, cand_b = _cu8_cands(modes8, i, k, c)
        mode = _decode_luma_mode(dec, cand_a, cand_b)
        modes8[i][k] = mode
        if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) != 0:
            raise NotImplementedError("non-DM chroma")
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        if cbf_y:
            _quad(lev_y[i], k)[:] = decode_residual(dec, 3, 0, residual_scan_idx(mode, 3, 0))
        if cbf_cb:
            _quad(lev_cb[i], k)[:] = decode_residual(dec, 2, 1, residual_scan_idx(mode, 2, 1))
        if cbf_cr:
            _quad(lev_cr[i], k)[:] = decode_residual(dec, 2, 2, residual_scan_idx(mode, 2, 2))


def encode_slice_data_intra_cu8(cfg, split, modes8, lev_y, lev_cb, lev_cr,
                                slice_qp=None, use_native: bool = True) -> bytes:
    sq = cfg.qp if slice_qp is None else slice_qp
    if use_native:
        from ..native import encode_slice_data_intra_cu8_native

        out = encode_slice_data_intra_cu8_native(
            cfg, split, modes8, lev_y, lev_cb, lev_cr, sq
        )
        if out is not None:
            return out
    enc = CabacEncoder(init_type=0, slice_qp=sq)
    nctu = cfg.ctbs_w * cfg.ctbs_h
    for i in range(nctu):
        _encode_ctu_i_cu8(enc, cfg, i, split, modes8, lev_y, lev_cb, lev_cr)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    return enc.data()


def decode_slice_data_intra_cu8(cfg, payload: bytes, slice_qp: int,
                                use_native: bool = True):
    if use_native:
        from ..native import decode_slice_data_intra_cu8_native

        out = decode_slice_data_intra_cu8_native(cfg, payload, slice_qp)
        if out is not None:
            return out
    dec = CabacDecoder(payload, init_type=0, slice_qp=slice_qp)
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    split = np.zeros(nctu, np.int32)
    modes8 = np.zeros((nctu, 4), np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    for i in range(nctu):
        _decode_ctu_i_cu8(dec, cfg, i, split, modes8, lev_y, lev_cb, lev_cr)
        end = dec.decode_terminate()
        if end != (1 if i == nctu - 1 else 0):
            raise ValueError(f"end_of_slice mismatch at CTU {i}")
    return split, modes8, lev_y, lev_cb, lev_cr


# ----------------------------------------------- CU8 + NxN (4x4 PUs, DST)

def _mode4_at(modes4: np.ndarray, i: int, r4: int, c4: int) -> int:
    """Mode of the 4x4 cell (r4, c4) in CTB i (z-order storage)."""
    k = (r4 >> 1) * 2 + (c4 >> 1)
    j = (r4 & 1) * 2 + (c4 & 1)
    return int(modes4[i][k * 4 + j])


def _cands4(modes4: np.ndarray, i: int, r4: int, c4: int, c_ctb: int) -> tuple:
    """MPM candidates (8.4.2) for a PU whose top-left 4x4 cell is (r4, c4):
    A = left neighbor (z-scan precedes -> always coded), B = above within
    the same CTB, else DC (above-CTB-row rule)."""
    if c4 > 0:
        a = _mode4_at(modes4, i, r4, c4 - 1)
    elif c_ctb > 0:
        a = _mode4_at(modes4, i - 1, r4, 3)
    else:
        a = 1
    b = _mode4_at(modes4, i, r4 - 1, c4) if r4 > 0 else 1
    return a, b


def _encode_ctu_i_cu8x(enc, cfg, i, split, part, modes4, lev_y, lev_cb, lev_cr) -> None:
    """I-CTU quadtree syntax with optional NxN (4x4 luma PUs + DST TUs).

    part: (nctu, 4) — sub-CU k uses PART_NxN; modes4: (nctu, 16) z-order
    4x4-cell modes (replicated within larger PUs)."""
    from ..core.tables import residual_scan_idx

    cw = cfg.ctbs_w
    r, c = divmod(i, cw)
    ctx = (1 if (c > 0 and split[i - 1]) else 0) + (
        1 if (r > 0 and split[i - cw]) else 0
    )
    enc.encode_bin(OFFSETS["split_cu_flag"] + ctx, int(split[i]))
    if not split[i]:
        ca, cb = _cands4(modes4, i, 0, 0, c)
        _encode_luma_mode(enc, int(modes4[i][0]), ca, cb)
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
        cbf_cb = 1 if np.any(lev_cb[i]) else 0
        cbf_cr = 1 if np.any(lev_cr[i]) else 0
        cbf_y = 1 if np.any(lev_y[i]) else 0
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
        if cbf_y:
            encode_residual(enc, lev_y[i], 4, 0)
        if cbf_cb:
            encode_residual(enc, lev_cb[i], 3, 1)
        if cbf_cr:
            encode_residual(enc, lev_cr[i], 3, 2)
        return
    for k in range(4):
        kr, kc = (k >> 1) * 2, (k & 1) * 2  # 4x4-cell coords of the sub-CU
        qy = _quad(lev_y[i], k)
        qcb = _quad(lev_cb[i], k)
        qcr = _quad(lev_cr[i], k)
        cbf_cb = 1 if np.any(qcb) else 0
        cbf_cr = 1 if np.any(qcr) else 0
        if not part[i][k]:  # PART_2Nx2N
            mode = int(modes4[i][k * 4])
            ca, cb = _cands4(modes4, i, kr, kc, c)
            enc.encode_bin(OFFSETS["part_mode"], 1)
            _encode_luma_mode(enc, mode, ca, cb)
            enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
            cbf_y = 1 if np.any(qy) else 0
            enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
            enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
            enc.encode_bin(OFFSETS["cbf_luma"] + 1, cbf_y)
            if cbf_y:
                encode_residual(enc, qy, 3, 0, residual_scan_idx(mode, 3, 0))
            if cbf_cb:
                encode_residual(enc, qcb, 2, 1, residual_scan_idx(mode, 2, 1))
            if cbf_cr:
                encode_residual(enc, qcr, 2, 2, residual_scan_idx(mode, 2, 2))
            continue
        # ---- PART_NxN (7.3.8.5): four 4x4 luma PUs
        enc.encode_bin(OFFSETS["part_mode"], 0)
        pus = [(kr, kc), (kr, kc + 1), (kr + 1, kc), (kr + 1, kc + 1)]
        modes = [_mode4_at(modes4, i, pr, pc) for pr, pc in pus]
        cands = []
        flags = []
        for j, (pr, pc) in enumerate(pus):
            ca, cb = _cands4(modes4, i, pr, pc, c)
            cands.append((ca, cb))
            mpm = _mpm_list_np(ca, cb)
            flags.append(modes[j] in mpm)
        for f in flags:  # the four prev_intra_luma_pred_flags come first
            enc.encode_bin(OFFSETS["prev_intra_luma_pred_flag"], 1 if f else 0)
        for j in range(4):  # then mpm_idx / rem_intra per PU
            _encode_luma_mode_tail(enc, modes[j], *cands[j], flags[j])
        enc.encode_bin(OFFSETS["intra_chroma_pred_mode"], 0)
        # transform_tree: forced split (IntraSplitFlag), chroma cbf at depth 0
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cb)
        enc.encode_bin(OFFSETS["cbf_chroma"], cbf_cr)
        dm = modes[0]  # chroma DM mode = PU0 (8.4.3)
        for j in range(4):
            t = _quad(qy, j)  # 4x4 luma TU (z-order)
            cbf_t = 1 if np.any(t) else 0
            enc.encode_bin(OFFSETS["cbf_luma"], cbf_t)  # trafoDepth 1 -> ctx 0
            if cbf_t:
                encode_residual(enc, t, 2, 0, residual_scan_idx(modes[j], 2, 0))
        if cbf_cb:
            encode_residual(enc, qcb, 2, 1, residual_scan_idx(dm, 2, 1))
        if cbf_cr:
            encode_residual(enc, qcr, 2, 2, residual_scan_idx(dm, 2, 2))


def _mpm_list_np(a: int, b: int) -> list:
    if a == b:
        if a < 2:
            return [0, 1, 26]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 1) % 32)]
    m2 = 0 if (a != 0 and b != 0) else (1 if (a != 1 and b != 1) else 26)
    return [a, b, m2]


def _encode_luma_mode_tail(enc, mode, a, b, in_mpm) -> None:
    """mpm_idx / rem_intra_luma_pred_mode (the part after the prev flag)."""
    mpm = _mpm_list_np(a, b)
    if in_mpm:
        idx = mpm.index(mode)
        enc.encode_bypass(1 if idx else 0)
        if idx:
            enc.encode_bypass(idx - 1)
    else:
        s = sorted(mpm, reverse=True)
        rem = mode
        for m in s:
            if mode > m:
                rem -= 1
        enc.encode_bypass_bits(rem, 5)


def _decode_luma_mode_tail(dec, a, b, prev_flag) -> int:
    mpm = _mpm_list_np(a, b)
    if prev_flag:
        idx = 0
        if dec.decode_bypass():
            idx = 1 + dec.decode_bypass()
        return mpm[idx]
    rem = dec.decode_bypass_bits(5)
    for m in sorted(mpm):
        if rem >= m:
            rem += 1
    return rem


_CHROMA_CAND = (0, 26, 10, 1)  # planar, vertical, horizontal, DC (8.4.3)


def _decode_chroma_mode(dec, luma_mode: int) -> int:
    """intra_chroma_pred_mode -> resolved chroma prediction mode (8.4.3):
    one context bin (0 = DM), else 2 bypass bins index the candidate list
    with the luma-duplicate replaced by angular 34."""
    if dec.decode_bin(OFFSETS["intra_chroma_pred_mode"]) == 0:
        return luma_mode
    idx = (dec.decode_bypass() << 1) | dec.decode_bypass()
    cand = _CHROMA_CAND[idx]
    return 34 if cand == luma_mode else cand


def _decode_ctu_i_cu8x(dec, cfg, i, split, part, modes4, lev_y, lev_cb, lev_cr,
                       cmode4=None) -> None:
    sdh = bool(getattr(cfg, "sign_data_hiding", False))
    from ..core.tables import residual_scan_idx

    cw = cfg.ctbs_w
    r, c = divmod(i, cw)
    ctx = (1 if (c > 0 and split[i - 1]) else 0) + (
        1 if (r > 0 and split[i - cw]) else 0
    )
    split[i] = dec.decode_bin(OFFSETS["split_cu_flag"] + ctx)
    if cmode4 is None:
        cmode4 = np.zeros((len(split), 4), np.int32)
    if not split[i]:
        ca, cb = _cands4(modes4, i, 0, 0, c)
        m = _decode_luma_mode(dec, ca, cb)
        modes4[i][:] = m
        cm = _decode_chroma_mode(dec, m)
        cmode4[i][:] = cm
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
        if cbf_y:
            lev_y[i] = decode_residual(dec, 4, 0, sdh=sdh)
        if cbf_cb:
            lev_cb[i] = decode_residual(dec, 3, 1, sdh=sdh)
        if cbf_cr:
            lev_cr[i] = decode_residual(dec, 3, 2, sdh=sdh)
        return
    for k in range(4):
        kr, kc = (k >> 1) * 2, (k & 1) * 2
        pm = dec.decode_bin(OFFSETS["part_mode"])
        if pm:  # 2Nx2N
            part[i][k] = 0
            ca, cb = _cands4(modes4, i, kr, kc, c)
            mode = _decode_luma_mode(dec, ca, cb)
            for j in range(4):
                modes4[i][k * 4 + j] = mode
            cm = _decode_chroma_mode(dec, mode)
            cmode4[i][k] = cm
            cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
            cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
            cbf_y = dec.decode_bin(OFFSETS["cbf_luma"] + 1)
            if cbf_y:
                _quad(lev_y[i], k)[:] = decode_residual(dec, 3, 0, residual_scan_idx(mode, 3, 0), sdh=sdh)
            if cbf_cb:
                _quad(lev_cb[i], k)[:] = decode_residual(dec, 2, 1, residual_scan_idx(cm, 2, 1), sdh=sdh)
            if cbf_cr:
                _quad(lev_cr[i], k)[:] = decode_residual(dec, 2, 2, residual_scan_idx(cm, 2, 2), sdh=sdh)
            continue
        part[i][k] = 1
        pus = [(kr, kc), (kr, kc + 1), (kr + 1, kc), (kr + 1, kc + 1)]
        flags = [dec.decode_bin(OFFSETS["prev_intra_luma_pred_flag"]) for _ in range(4)]
        modes = []
        for j, (pr, pc) in enumerate(pus):
            ca, cb = _cands4(modes4, i, pr, pc, c)
            mode = _decode_luma_mode_tail(dec, ca, cb, flags[j])
            modes.append(mode)
            modes4[i][k * 4 + j] = mode
        cm = _decode_chroma_mode(dec, modes[0])
        cmode4[i][k] = cm
        cbf_cb = dec.decode_bin(OFFSETS["cbf_chroma"])
        cbf_cr = dec.decode_bin(OFFSETS["cbf_chroma"])
        qy = np.zeros((8, 8), np.int32)
        for j in range(4):
            if dec.decode_bin(OFFSETS["cbf_luma"]):
                _quad(qy, j)[:] = decode_residual(dec, 2, 0, residual_scan_idx(modes[j], 2, 0), sdh=sdh)
        _quad(lev_y[i], k)[:] = qy
        if cbf_cb:
            _quad(lev_cb[i], k)[:] = decode_residual(dec, 2, 1, residual_scan_idx(cm, 2, 1), sdh=sdh)
        if cbf_cr:
            _quad(lev_cr[i], k)[:] = decode_residual(dec, 2, 2, residual_scan_idx(cm, 2, 2), sdh=sdh)


def encode_slice_data_intra_cu8x(cfg, split, part, modes4, lev_y, lev_cb, lev_cr,
                                 slice_qp=None, use_native: bool = True) -> bytes:
    """CU8 quadtree slice data with NxN support.  Dispatches to the native
    codec when no CTB uses NxN (identical bitstream in that case)."""
    sq = cfg.qp if slice_qp is None else slice_qp
    if use_native and not np.any(part):
        from ..native import encode_slice_data_intra_cu8_native

        modes8 = np.ascontiguousarray(np.asarray(modes4).reshape(-1, 4, 4)[:, :, 0])
        out = encode_slice_data_intra_cu8_native(
            cfg, split, modes8, lev_y, lev_cb, lev_cr, sq
        )
        if out is not None:
            return out
    enc = CabacEncoder(init_type=0, slice_qp=sq)
    nctu = cfg.ctbs_w * cfg.ctbs_h
    for i in range(nctu):
        _encode_ctu_i_cu8x(enc, cfg, i, split, part, modes4, lev_y, lev_cb, lev_cr)
        enc.encode_terminate(1 if i == nctu - 1 else 0)
    return enc.data()


def decode_slice_data_intra_cu8x(cfg, payload: bytes, slice_qp: int,
                                 return_cmode: bool = False, sao=None):
    dec = CabacDecoder(payload, init_type=0, slice_qp=slice_qp)
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    split = np.zeros(nctu, np.int32)
    part = np.zeros((nctu, 4), np.int32)
    modes4 = np.zeros((nctu, 16), np.int32)
    cmode4 = np.zeros((nctu, 4), np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    for i in range(nctu):
        if sao is not None:
            sao.decode(dec, i)
        _decode_ctu_i_cu8x(dec, cfg, i, split, part, modes4, lev_y, lev_cb, lev_cr,
                           cmode4)
        end = dec.decode_terminate()
        if end != (1 if i == nctu - 1 else 0):
            raise ValueError(f"end_of_slice mismatch at CTU {i}")
    if return_cmode:
        return split, part, modes4, cmode4, lev_y, lev_cb, lev_cr
    return split, part, modes4, lev_y, lev_cb, lev_cr


def encode_slice_data_intra_cu8x_wpp(cfg, split, part, modes4, lev_y, lev_cb,
                                     lev_cr, slice_qp=None, sao=None):
    """CU8-quadtree I-slice with WPP substreams (entropy_coding_sync)."""
    sq = cfg.qp if slice_qp is None else slice_qp

    def fn(enc, i):
        if sao is not None:
            sao.encode(enc, i)
        _encode_ctu_i_cu8x(enc, cfg, i, split, part, modes4, lev_y, lev_cb, lev_cr)

    fn.init_type = 0
    return encode_slice_data_wpp(cfg, fn, slice_qp=sq)


def decode_slice_data_intra_cu8x_wpp(cfg, payload, entry_offsets, slice_qp,
                                     sao=None):
    """WPP inverse; returns (split, part, modes4, cmode4, lev_y, lev_cb, lev_cr)."""
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    split = np.zeros(nctu, np.int32)
    part = np.zeros((nctu, 4), np.int32)
    modes4 = np.zeros((nctu, 16), np.int32)
    cmode4 = np.zeros((nctu, 4), np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)

    def fn(dec, i):
        if sao is not None:
            sao.decode(dec, i)
        _decode_ctu_i_cu8x(dec, cfg, i, split, part, modes4, lev_y, lev_cb, lev_cr,
                           cmode4)

    decode_slice_data_wpp(cfg, payload, entry_offsets, fn, 0, slice_qp)
    return split, part, modes4, cmode4, lev_y, lev_cb, lev_cr
