"""Block matching costs: Hadamard SATD (counterpart of kvazzup_tpu/ops/satd.py).

`_satd_tile` is the one plain SATD of the port: `satd_blocks` runs it over
(..., N, N) tiles, and `hopper_q.satd_rows_plain` (the hand kernel's plain
version, which the encoder's `ctu_kernels.satd_flat` reaches on the CPU)
over flat rows.
"""

from __future__ import annotations

import numpy as np
import torch


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _hadamard_1d(x, dim: int):
    """Unnormalised Walsh-Hadamard transform along `dim` (length 4 or 8)."""
    n = x.shape[dim]
    h = 1
    while h < n:
        shp = list(x.shape)
        shp[dim:dim + 1] = [n // (2 * h), 2, h]
        y = x.reshape(shp)
        a, b = y.select(dim + 1, 0), y.select(dim + 1, 1)
        x = torch.stack([a + b, a - b], dim=dim + 1).reshape(x.shape)
        h *= 2
    return x


def _satd_tile(diff, block: int):
    """(..., b, b) int32 residual tiles -> (...,) rounded Hadamard SATD.

    The sum of absolute Hadamard coefficients does not depend on the row
    order of the Hadamard matrix, so int32 butterflies stand in for the
    H @ D @ H product (exact on every device)."""
    t = _hadamard_1d(_hadamard_1d(diff, diff.ndim - 1), diff.ndim - 2)
    s = t.abs().sum(dim=(-2, -1))
    return (s + 2) >> 2 if block == 8 else (s + 1) >> 1


def satd_blocks(a, b, block: int = 8):
    """SATD of (..., N, N) vs (..., N, N) tiled into `block`-sized Hadamards."""
    n = a.shape[-1]
    diff = (a.to(torch.int32) - b.to(torch.int32))
    if n < block:
        if n == 4:
            return _satd_tile(diff, 4)
        return diff.abs().sum(dim=(-2, -1))
    bs = n // block
    d = diff.reshape(*diff.shape[:-2], bs, block, bs, block).transpose(-3, -2)
    return _satd_tile(d, block).sum(dim=(-2, -1))
