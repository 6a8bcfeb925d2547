"""Intra deblocking boundary strengths of a quadtree picture
(counterpart of `quad_bs_maps` in kvazzup_tpu/encoder/cu32.py; the
sequential CTB32 reference encoder there is not ported)."""

from __future__ import annotations

import numpy as np

from .frame_intra32 import ZO


def quad_bs_maps(trees, width: int, height: int, ctb_log2: int):
    """bS maps of an all-intra quadtree picture on the 8-sample edge grid:
    2 on every CU and TU edge (a CU64 leaf's forced TU32s and an explicit
    TU split included), else 0.  Returns (bs_v (W/8 - 1, H/8), bs_h
    (H/8 - 1, W/8)) int32."""
    h8, w8 = height // 8, width // 8
    ev = np.zeros((h8, w8), bool)
    eh = np.zeros((h8, w8), bool)

    def mark(x0, y0, n):
        if x0 % 8 == 0 and x0 // 8 < w8:
            ev[y0 // 8:-(-(y0 + n) // 8), x0 // 8] = True
        if y0 % 8 == 0 and y0 // 8 < h8:
            eh[y0 // 8, x0 // 8:-(-(x0 + n) // 8)] = True

    def walk(node, x0, y0, n):
        if "split" in node:
            h = n >> 1
            for (dy, dx), s in zip(ZO, node["split"]):
                walk(s, x0 + dx * h, y0 + dy * h, h)
            return
        if n == 64:  # forced transform split: the four TU32s' edges too
            for dy, dx in ZO:
                mark(x0 + dx * 32, y0 + dy * 32, 32)
        elif node.get("tsplit"):
            for dy, dx in ZO:
                mark(x0 + dx * (n >> 1), y0 + dy * (n >> 1), n >> 1)
        else:
            mark(x0, y0, n)

    cw = width >> ctb_log2
    nctb = 1 << ctb_log2
    for i, t in enumerate(trees):
        walk(t, (i % cw) * nctb, (i // cw) * nctb, nctb)
    bs_v = np.zeros((w8 - 1, h8), np.int32)
    for e in range(1, w8):
        bs_v[e - 1, :] = 2 * ev[:, e]
    bs_h = np.zeros((h8 - 1, w8), np.int32)
    for e in range(1, h8):
        bs_h[e - 1, :] = 2 * eh[e, :]
    return bs_v, bs_h
