"""CU-quadtree slice data through the native CABAC writer (counterpart of
the native frontend of kvazzup_tpu/entropy/quad.py: I, P and B slices,
with or without WPP, so the low-delay CTB64 path and random access at
CTB64; no tiles or cu_qp_delta).

The decision trees (the reference's cu32 format, from
`encoder/frame_intra64`, `encoder/frame_inter64` and `encoder/frame_b64`) are flattened into a
token stream and a level stream (`_serialize_trees`) for
`native.encode_slice_quad_native`, which writes 7.3.8 syntax with SAO
parameters before each CTU when given, and with WPP one substream per CTB
row (entropy_coding_sync: each row's contexts inherited from the row
above) and their lengths.  The reference's Python writer is
not ported: a writer that cannot run raises instead of falling back.
"""

from __future__ import annotations

import numpy as np

from ..native import encode_slice_quad_native


def _serialize_trees(cfg, trees, slice_type: int):
    """Flatten the tree dicts into the native writer's token / level
    streams (the grammar of slice_cabac.c `encode_slice_quad_c`).

    Leaves partition each CTB, so every CTB contributes exactly n^2 +
    2 (n/2)^2 = 1.5 S^2 coefficients whatever its split shape."""
    toks: list[int] = []
    min_cb = cfg.min_cb_log2
    size = cfg.ctb_size
    levels = np.empty(len(trees) * (3 * size * size) // 2, np.int32)
    pos = [0]

    def put(a):
        n = a.size
        levels[pos[0]:pos[0] + n] = a.reshape(-1)
        pos[0] += n

    def walk(node, log2):
        split = "split" in node
        if log2 > min_cb:
            toks.append(1 if split else 0)
        if split:
            for sub in node["split"]:
                walk(sub, log2 - 1)
            return
        if slice_type != 2:
            ct = int(node.get("ctype", 0))
            toks.append(ct)
            if ct in (1, 3):
                toks.append(int(node["merge_idx"]))
            elif ct == 2 and slice_type == 0:
                # B AMVP: [inter_dir] + (mvd_x mvd_y mvp) per active list
                dr = int(node["inter_dir"])
                toks.append(dr)
                for li in range(2):
                    if dr & (1 << li):
                        toks.extend((int(node["mvd"][li][0]), int(node["mvd"][li][1]),
                                     int(node["mvp_flag"][li])))
            elif ct == 2:
                toks.extend((int(node["mvd"][0]), int(node["mvd"][1]), int(node["mvp_flag"])))
            if ct:
                put(node["lev_y"])
                put(node["lev_cb"])
                put(node["lev_cr"])
                return
        nxn = 1 if node.get("part") else 0
        toks.append(nxn)
        modes = node["modes"]
        if nxn:
            toks.extend(int(m) for m in modes[:4])
        else:
            toks.append(int(modes[0]))
        toks.append(int(node.get("tsplit", 0)))
        put(node["lev_y"])
        put(node["lev_cb"])
        put(node["lev_cr"])

    for tree in trees:
        walk(tree, cfg.ctb_log2)
    return np.asarray(toks, np.int32), levels


def _native_quad(cfg, trees, slice_type: int, wpp: bool, slice_qp, sao, merge_k: int):
    """(payload, substream lengths or None) from the native writer."""
    sq = cfg.qp if slice_qp is None else slice_qp
    tokens, levels = _serialize_trees(cfg, trees, slice_type)
    out = encode_slice_quad_native(cfg, slice_type, wpp, tokens, levels, sq, sao=sao,
                                   merge_k=merge_k)
    if out is None:
        raise RuntimeError("the native quadtree CABAC writer refused the slice "
                           f"(slice type {slice_type}, {len(trees)} CTBs)")
    return out


def encode_slice_data_intra_quad(cfg, trees, slice_qp=None, sao=None) -> bytes:
    """I-slice data of the quadtree trees (one slice, CTBs in raster
    order); `sao` (a SaoState) puts its per-CTB parameters before each
    CTU's syntax (7.3.8.2)."""
    return _native_quad(cfg, trees, 2, False, slice_qp, sao, 1)[0]


def encode_slice_data_p_quad(cfg, trees, slice_qp=None, sao=None, merge_k: int = 1) -> bytes:
    """P-slice data of the quadtree trees (one slice, init_type 1)."""
    return _native_quad(cfg, trees, 1, False, slice_qp, sao, merge_k)[0]


def encode_slice_data_intra_quad_wpp(cfg, trees, slice_qp=None, sao=None):
    """WPP I-slice data: one substream per CTB row.  Returns (payload,
    entry_point_offsets), the substreams' byte lengths before emulation
    prevention (`core.nal.ebsp_entry_offsets` converts them)."""
    return _native_quad(cfg, trees, 2, True, slice_qp, sao, 1)


def encode_slice_data_p_quad_wpp(cfg, trees, slice_qp=None, sao=None, merge_k: int = 1):
    """WPP P-slice data: as `encode_slice_data_intra_quad_wpp`."""
    return _native_quad(cfg, trees, 1, True, slice_qp, sao, merge_k)


def encode_slice_data_b_quad(cfg, trees, slice_qp=None, sao=None, merge_k: int = 1) -> bytes:
    """B-slice data of the quadtree trees (one slice, init_type 2): inter
    leaves code inter_pred_idc and each active list's mvd and mvp flag."""
    return _native_quad(cfg, trees, 0, False, slice_qp, sao, merge_k)[0]


def encode_slice_data_b_quad_wpp(cfg, trees, slice_qp=None, sao=None, merge_k: int = 1):
    """WPP B-slice data: as `encode_slice_data_intra_quad_wpp`."""
    return _native_quad(cfg, trees, 0, True, slice_qp, sao, merge_k)
