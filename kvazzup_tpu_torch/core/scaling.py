"""HEVC scaling lists (7.3.4 / 7.4.5 / 8.6.3).

Explicit and default quantization matrices — the openHEVC-envelope
feature the round-1 decoder lacked (uvgComm dependencies/
openhevc.cmake:10-14 pulls a decoder that handles them).  A parsed
stream yields per-(sizeId, matrixId) ScalingFactor matrices; dequant
multiplies per-coefficient instead of the flat m = 16.
"""

from __future__ import annotations

import numpy as np

from .tables import diag_scan

# Table 7-5: default 8x8 lists (raster order), intra / inter
DEFAULT_8X8_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115,
], np.int32).reshape(8, 8)
DEFAULT_8X8_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91,
], np.int32).reshape(8, 8)


def _default_list(size_id: int, matrix_id: int) -> np.ndarray:
    """Default ScalingList as a coefficient matrix at the LIST size
    (4x4 for sizeId 0, else 8x8), [y][x] raster."""
    if size_id == 0:
        return np.full((4, 4), 16, np.int32)
    intra = matrix_id < 3 if size_id < 3 else matrix_id == 0
    return (DEFAULT_8X8_INTRA if intra else DEFAULT_8X8_INTER).copy()


def _default_dc(size_id: int, matrix_id: int) -> int:
    return 16  # Table 7-6 defaults: DC = 16 for both default lists


def _upsample(base: np.ndarray, factor: int, dc: int) -> np.ndarray:
    """ScalingFactor for 16x16/32x32: 8x8 list upsampled, DC overridden
    (7.4.5)."""
    m = np.repeat(np.repeat(base, factor, axis=0), factor, axis=1)
    m[0, 0] = dc
    return m


class ScalingLists:
    """ScalingFactor[sizeId][matrixId] matrices ([y][x], size 4..32)."""

    def __init__(self) -> None:
        self.factors: dict[tuple[int, int], np.ndarray] = {}
        for size_id in range(4):
            n_mat = 6 if size_id < 3 else 2
            for matrix_id in range(n_mat):
                self._set_default(size_id, matrix_id)

    def _set_default(self, size_id: int, matrix_id: int) -> None:
        base = _default_list(size_id, matrix_id)
        if size_id >= 2:
            base = _upsample(base, 1 << (size_id - 1), _default_dc(size_id, matrix_id))
        self.factors[(size_id, matrix_id)] = base

    def factor(self, log2_size: int, c_idx: int, intra: bool) -> np.ndarray:
        """ScalingFactor matrix for one TU (log2 2..5)."""
        size_id = log2_size - 2
        if size_id == 3:
            matrix_id = 0 if intra else 1  # 32x32: luma only in 4:2:0
        else:
            matrix_id = (0 if intra else 3) + c_idx
        return self.factors[(size_id, matrix_id)]


def parse_scaling_list_data(r) -> ScalingLists:
    """scaling_list_data() (7.3.4) -> ScalingLists."""
    out = ScalingLists()
    lists: dict[tuple[int, int], np.ndarray] = {}  # list-size matrices
    dcs: dict[tuple[int, int], int] = {}
    for size_id in range(4):
        n_mat = 6 if size_id < 3 else 2
        step = 1 if size_id < 3 else 3
        for matrix_id in range(n_mat):
            pred_mode = r.flag()
            if not pred_mode:
                # refMatrixId = matrixId - delta * step; our matrix_id
                # already counts in units of `step` (sizeId 3: {0, 1})
                delta = r.ue()
                if delta == 0:
                    lists[(size_id, matrix_id)] = _default_list(size_id, matrix_id)
                    dcs[(size_id, matrix_id)] = _default_dc(size_id, matrix_id)
                else:
                    ref = matrix_id - delta
                    lists[(size_id, matrix_id)] = lists[(size_id, ref)].copy()
                    dcs[(size_id, matrix_id)] = dcs[(size_id, ref)]
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                dc = 8
                if size_id > 1:
                    dc = 8 + r.se()
                    next_coef = dc
                n = 4 if size_id == 0 else 8
                scan = diag_scan(n)
                m = np.zeros((n, n), np.int32)
                for i in range(coef_num):
                    next_coef = (next_coef + r.se() + 256) % 256
                    x, y = scan[i]
                    m[y, x] = next_coef
                lists[(size_id, matrix_id)] = m
                dcs[(size_id, matrix_id)] = dc
            base = lists[(size_id, matrix_id)]
            if size_id >= 2:
                out.factors[(size_id, matrix_id)] = _upsample(
                    base, 1 << (size_id - 1), dcs[(size_id, matrix_id)])
            else:
                out.factors[(size_id, matrix_id)] = base.copy()
    return out
