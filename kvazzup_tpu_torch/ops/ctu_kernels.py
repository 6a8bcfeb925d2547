"""CTU compute over flattened blocks (counterpart of kvazzup_tpu/ops/ctu_kernels.py).

* all-35-mode intra prediction = one (B, 130) @ (130, 35*N^2) matmul over the
  [raw | filtered] boundary walk, plus the DC and mode-10/26 edge fixups;
* 2-D DCT stages = Kronecker-factor (N^2, N^2) matmuls;
* Hadamard SATD = the hand kernel in `hopper_q.satd_rows`.

The matmuls run in float32 with exact integer semantics: operands are
bounded so every partial sum stays below 2^24, with an 8-bit limb split
where inputs exceed 9 bits.  `runtime` turns TF32 off, which this needs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..runtime import device_const
from . import hopper_q
from . import intra as intra_ops
from .transforms import transform_matrices

F32 = torch.float32


def exact_matmul_small(x_int, w_f32):
    """Exact integer matmul for |x| * row_sum(|w|) < 2^24."""
    return torch.matmul(x_int.to(torch.float32), w_f32).to(torch.int32)


def exact_matmul_i17(x_int, w_f32):
    """Exact integer matmul for up-to-17-bit |x| via an 8-bit limb split."""
    hi = x_int >> 8
    lo = x_int & 255
    return exact_matmul_small(hi, w_f32) * 256 + exact_matmul_small(lo, w_f32)


# ------------------------------------------------------------- transforms


@functools.lru_cache(maxsize=None)
def _kron_stages(log2: int, dst: bool, inverse: bool):
    m = transform_matrices(log2, dst).astype(np.float32)
    eye = np.eye(1 << log2, dtype=np.float32)
    if not inverse:
        return np.kron(m.T, eye), np.kron(eye, m.T)
    return np.kron(m, eye), np.kron(eye, m)


def _stages(log2, dst, inverse, device):
    w1, w2 = _kron_stages(log2, dst, inverse)
    key = ("kron", log2, dst, inverse)
    return (device_const(key + (1,), lambda: w1, device, F32),
            device_const(key + (2,), lambda: w2, device, F32))


def fwd_transform_flat(resid, log2: int, dst: bool = False, bd: int = 8):
    """resid: (..., N^2) int32 in [-(2^bd - 1), 2^bd - 1] -> coefficients."""
    w1, w2 = _stages(log2, dst, False, resid.device)
    s1 = log2 + bd - 9
    s2 = log2 + 6
    tmp = (exact_matmul_small(resid, w1) + (1 << (s1 - 1))) >> s1
    return (exact_matmul_i17(tmp, w2) + (1 << (s2 - 1))) >> s2


def inv_transform_flat(coef, log2: int, dst: bool = False, bd: int = 8):
    """coef: (..., N^2) int16-range int32 -> residual (..., N^2)."""
    w1, w2 = _stages(log2, dst, True, coef.device)
    tmp = ((exact_matmul_i17(coef, w1) + 64) >> 7).clamp(-32768, 32767)
    res = (exact_matmul_i17(tmp, w2) + (1 << (19 - bd))) >> (20 - bd)
    return res.clamp(-32768, 32767)


# ------------------------------------------------------------------ SATD


def satd_flat(a, b, log2: int):
    """SATD between (..., N^2) blocks; `b` broadcasts against `a`.

    A `b` whose leading dims are a prefix of a's followed by ones (the
    original block against every prediction) is passed to the kernel
    without expanding it."""
    a = a.to(torch.int32).contiguous()
    b = b.to(torch.int32)
    k = a.shape[-1]
    lead = a.shape[:-1]
    group = 1
    if b.shape[:-1] != lead:
        j = next((j for j in range(len(lead) + 1)
                  if b.ndim == a.ndim and b.shape[:j] == lead[:j]
                  and all(s == 1 for s in b.shape[j:-1])), None)
        if j is None:
            b = b.expand(a.shape)
        else:
            group = math.prod(lead[j:])
    out = hopper_q.satd_rows(a.reshape(-1, k), b.contiguous().reshape(-1, k),
                             log2, group)
    return out.reshape(lead)


# ----------------------------------------------------------- intra modes


@functools.lru_cache(maxsize=None)
def _intra_weights(log2: int, is_luma: bool):
    """(130, 35*N^2) weight matrix + bias for the common-shift main path.

    Modes 2..34 and planar (0) come from the matmul; DC (1) and the
    mode-10/26 edge clips are fixed up afterwards.  Column layout:
    mode * N^2 + y * N + x; input layout [raw A (4N+1) | filtered A].
    """
    n = 1 << log2
    ln = 4 * n + 1
    shift = max(5, log2 + 1)
    ang_scale = 1 << (shift - 5)
    i1, i2, fr, filt = intra_ops._angular_tables(log2, is_luma)
    w = np.zeros((2 * ln, 35 * n * n), np.float32)
    bias = np.zeros((35 * n * n,), np.float32)
    for m in range(33):
        mode = m + 2
        off = ln if filt[m] else 0
        for y in range(n):
            for x in range(n):
                col = mode * n * n + y * n + x
                w[off + i1[m, y, x], col] += (32 - fr[m, y, x]) * ang_scale
                w[off + i2[m, y, x], col] += fr[m, y, x] * ang_scale
                bias[col] = 16 * ang_scale
    scale = (1 << shift) >> (log2 + 1)
    off = ln if (is_luma and n >= 8) else 0
    for y in range(n):
        for x in range(n):
            col = y * n + x
            w[off + (2 * n - 1 - y), col] += (n - 1 - x) * scale  # left[y]
            w[off + (2 * n + 1 + x), col] += (n - 1 - y) * scale  # top[x]
            w[off + (3 * n + 1), col] += (x + 1) * scale  # top-right p[N][-1]
            w[off + (n - 1), col] += (y + 1) * scale  # bottom-left p[-1][N]
            bias[col] = n * scale
    return w, bias, shift


def _edges(a, n: int):
    top = a[:, 2 * n + 1:3 * n + 1]
    left = a[:, n:2 * n].flip(-1)  # y = 0..N-1
    corner = a[:, 2 * n]
    return top, left, corner


def _dc_pred(top, left, n: int, log2: int, is_luma: bool):
    dc = (top.sum(-1) + left.sum(-1) + n) >> (log2 + 1)
    d2 = dc[:, None, None].expand(-1, n, n).clone()
    if is_luma and n < 32:
        d2[:, 0, :] = (top + 3 * dc[:, None] + 2) >> 2
        d2[:, :, 0] = (left + 3 * dc[:, None] + 2) >> 2
        d2[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    return d2.reshape(-1, n * n).to(torch.int32)


def _walk_pair(a, is_luma: bool):
    af = intra_ops.filter_refs(a) if is_luma else a
    return torch.cat([a, af], dim=-1)


def _modes_main(a, log2: int, is_luma: bool, modes):
    """Shift-rounded matmul predictions for `modes` (None = all 35)."""
    n = 1 << log2
    w, bias, shift = _intra_weights(log2, is_luma)
    if modes is None:
        key, wsel, bsel, count = ("intra", log2, is_luma), w, bias, 35
    else:
        cols = np.concatenate([np.arange(m * n * n, (m + 1) * n * n) for m in modes])
        key, wsel, bsel, count = ("intra", log2, is_luma, tuple(modes)), w[:, cols], bias[cols], len(modes)
    wt = device_const(key + ("w",), lambda: wsel, a.device, F32)
    bt = device_const(key + ("b",), lambda: bsel, a.device, torch.int32)
    main = (exact_matmul_small(_walk_pair(a, is_luma), wt) + bt) >> shift
    return main.reshape(a.shape[0], count, n * n)


def _edge_fix(preds, k: int, a, n: int, mode: int, bd: int):
    """Mode 10 (first row) / 26 (first column) boundary clip, in place."""
    mx = (1 << bd) - 1
    top, left, corner = _edges(a, n)
    pk = preds[:, k].reshape(-1, n, n)
    if mode == 10:
        pk[:, 0, :] = (left[:, :1] + ((top - corner[:, None]) >> 1)).clamp(0, mx)
    else:
        pk[:, :, 0] = (top[:, :1] + ((left - corner[:, None]) >> 1)).clamp(0, mx)


def predict_all_modes_flat(a, log2: int, is_luma: bool, bd: int = 8):
    """a: (B, 4N+1) int32 substituted walk -> (B, 35, N^2) int32 predictions."""
    return predict_modes_subset_flat(a, log2, is_luma, None, bd)


def predict_modes_subset_flat(a, log2: int, is_luma: bool, modes, bd: int = 8):
    """Predictions for `modes` (tuple of mode numbers; None = all 35, in mode
    order).  Per-mode output equals predict_all_modes_flat's."""
    n = 1 << log2
    mode_list = list(range(35)) if modes is None else list(modes)
    preds = _modes_main(a, log2, is_luma, modes)
    if 1 in mode_list:
        top, left, _ = _edges(a, n)
        preds[:, mode_list.index(1)] = _dc_pred(top, left, n, log2, is_luma)
    if is_luma and n < 32:
        for mode in (10, 26):
            if mode in mode_list:
                _edge_fix(preds, mode_list.index(mode), a, n, mode, bd)
    return preds
