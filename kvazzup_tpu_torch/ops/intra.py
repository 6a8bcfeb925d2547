"""HEVC intra prediction support (counterpart of kvazzup_tpu/ops/intra.py).

The reference samples form one boundary walk `A[0..4N]` = [left column
bottom->top, corner, top row left->right].  Every angular mode is a static
pair of index tables plus interpolation weights into A
(`_angular_tables`, numpy); `ctu_kernels` folds them into one matmul.
This module also holds reference substitution at CTB granularity
(8.4.4.2.2) and the [1,2,1] smoothing filter (8.4.4.2.3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.tables import (INTRA_INV_ANGLE, INTRA_PRED_ANGLE,
                                     intra_hor_ver_dist_thres)


def _angle(mode: int) -> int:
    return int(INTRA_PRED_ANGLE[mode - 2])


def _inv_angle(mode: int) -> int:
    return int(INTRA_INV_ANGLE[mode - 11])


def _filter_flag(mode: int, n: int, is_luma: bool) -> bool:
    """Reference smoothing decision (8.4.4.2.3)."""
    if not is_luma or mode == 1 or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    return min_dist > intra_hor_ver_dist_thres(n)


@functools.lru_cache(maxsize=None)
def _angular_tables(log2: int, is_luma: bool):
    """Static (33, N, N) index/weight tables for modes 2..34.

    Returns (I1, I2, F, use_filtered): the prediction is
    ((32-F)*S[I1] + F*S[I2] + 16) >> 5 with S the (possibly filtered) walk.
    """
    n = 1 << log2
    i1 = np.zeros((33, n, n), dtype=np.int32)
    i2 = np.zeros((33, n, n), dtype=np.int32)
    fr = np.zeros((33, n, n), dtype=np.int32)
    filt = np.zeros((33,), dtype=bool)
    for mode in range(2, 35):
        m = mode - 2
        ang = _angle(mode)
        filt[m] = _filter_flag(mode, n, is_luma)
        vertical = mode >= 18

        # ref[k] in walk coordinates: vertical modes read A[2N + k], the
        # horizontal ones A[2N - k]; k < 0 projects onto the other side
        # through invAngle (8.4.4.2.6)
        def ref_to_a(k: int) -> int:
            if k >= 0:
                return 2 * n + k if vertical else 2 * n - k
            proj = (k * _inv_angle(mode) + 128) >> 8
            return 2 * n - proj if vertical else 2 * n + proj

        for y in range(n):
            for x in range(n):
                u, v = (x, y) if vertical else (y, x)
                idx = ((v + 1) * ang) >> 5
                fact = ((v + 1) * ang) & 31
                a1 = ref_to_a(u + idx + 1)
                a2 = ref_to_a(u + idx + 2) if fact else a1
                i1[m, y, x] = a1
                i2[m, y, x] = a2
                fr[m, y, x] = fact
    if i1.min() < 0 or max(i1.max(), i2.max()) > 4 * n:
        raise AssertionError("angular table index outside the boundary walk")
    return i1, i2, fr, filt


def substitute_refs_ctb(a_raw, left, above, above_right, n: int, bd: int = 8):
    """Reference substitution (8.4.4.2.2) for whole-CTB availability.

    a_raw: (..., 4n+1) int32; left/above/above_right: (...,) bool.  The
    below-left run is never available; every other segment (left column,
    corner, top row, top-right row) is available as a whole.
    """
    A = a_raw
    l = left[..., None]
    a = above[..., None]
    tr = above_right[..., None]
    mid = torch.full_like(A[..., n:n + 1], 1 << (bd - 1))
    first = torch.where(l, A[..., n:n + 1],
                        torch.where(a, A[..., 2 * n + 1:2 * n + 2], mid))
    lseg = torch.where(l, A[..., n:2 * n], first)
    ltop = A[..., 2 * n - 1:2 * n]  # top-most left-column sample
    corner = torch.where(l & a, A[..., 2 * n:2 * n + 1],
                         torch.where(l, ltop, first))
    tseg = torch.where(a, A[..., 2 * n + 1:3 * n + 1],
                       torch.where(l, ltop, first))
    trseg = torch.where(tr, A[..., 3 * n + 1:], tseg[..., n - 1:n])
    lbseg = first.expand(A[..., :n].shape)
    return torch.cat([lbseg, lseg, corner, tseg, trseg], dim=-1)


def filter_refs(a):
    """[1,2,1]/4 smoothing along the boundary walk; endpoints unfiltered."""
    f = (a[..., :-2] + 2 * a[..., 1:-1] + a[..., 2:] + 2) >> 2
    return torch.cat([a[..., :1], f, a[..., -1:]], dim=-1)
