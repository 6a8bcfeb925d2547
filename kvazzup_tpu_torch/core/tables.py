"""Golden HEVC constant tables (ITU-T H.265 normative constants).

Counterpart of kvazaar's `tables.c` / `scalinglist.c` (Data structures group,
dependencies/kvazaar_CMakeLists.txt:207-218).  Everything here is a constant
mandated by the spec: transform basis matrices (8.6.4), scan orders (6.5.3),
quantization scales (8.6.3), intra angle parameters (8.4.4.2.6), chroma QP
mapping (Table 8-10).
"""

from __future__ import annotations

import numpy as np

# ------------------------------------------------------------- transforms
#
# The 32-point integer DCT-II basis (H.265 8.6.4.2) contains only the values
# below (up to sign); entry M32[k][n] depends solely on (k*(2n+1)) mod 128
# folded into the first quarter wave.  The N-point matrices are row
# subsamples: M_N[k][n] = M32[k*32/N][n].  The published coefficient lists
# (which deviate from rounded cosines in a few places — e.g. 25 where the
# cosine rounds to 26) are the normative source of truth.

_ODD4 = [83, 36]
_ODD8 = [89, 75, 50, 18]
_ODD16 = [90, 87, 80, 70, 57, 43, 25, 9]
_ODD32 = [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]


def _quarter(j: int) -> int:
    """Value of the integer quarter-wave table at index j in [0, 32]."""
    if j == 0:
        return 64
    a = (j & -j).bit_length() - 1  # largest power of two dividing j
    q = j >> a
    table = [_ODD32, _ODD16, _ODD8, _ODD4, [64]][a]
    return table[(q - 1) // 2]


def _m32(k: int, n: int) -> int:
    idx = (k * (2 * n + 1)) % 128
    if idx > 64:
        idx = 128 - idx
    if idx > 32:
        return -_quarter(64 - idx)
    return _quarter(idx)


def _make_dct(n: int) -> np.ndarray:
    step = 32 // n
    return np.array(
        [[_m32(k * step, i) for i in range(n)] for k in range(n)], dtype=np.int32
    )


DCT4 = _make_dct(4)
DCT8 = _make_dct(8)
DCT16 = _make_dct(16)
DCT32 = _make_dct(32)
_DCT_MATRICES = {4: DCT4, 8: DCT8, 16: DCT16, 32: DCT32}


def dct_matrix(n: int) -> np.ndarray:
    """The N-point HEVC integer DCT matrix (rows = basis vectors)."""
    return _DCT_MATRICES[n]


# 4x4 DST-VII matrix (H.265 8.6.4.1, used for 4x4 intra luma TBs)
DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)

# ------------------------------------------------------------- quantization

# Forward quantizer scales (HM/kvazaar g_quantScales; encoder-side, 14-bit)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
# Normative inverse scales levScale (H.265 8.6.3)
DEQUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# ------------------------------------------------------------- chroma QP

# Table 8-10: qPi -> QpC for ChromaArrayType == 1
_CHROMA_QP_MAP = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    qpi = max(0, min(57, qp_y + offset))
    if qpi < 30:
        return qpi
    if qpi <= 43:
        return _CHROMA_QP_MAP[qpi - 30]
    return qpi - 6


# full qPi (0..57) -> QpC lookup for traced-QP device code
CHROMA_QP_TABLE = np.array([chroma_qp(q) for q in range(58)], dtype=np.int32)


# ------------------------------------------------------------- scan orders

SCAN_DIAG, SCAN_HORIZ, SCAN_VERT = 0, 1, 2


def diag_scan(size: int) -> np.ndarray:
    """Up-right diagonal scan order (6.5.3): array of (x, y) in scan order."""
    pos = []
    x = y = 0
    while len(pos) < size * size:
        while y >= 0:
            if x < size and y < size:
                pos.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(pos, dtype=np.int32)


def horiz_scan(size: int) -> np.ndarray:
    return np.array([(x, y) for y in range(size) for x in range(size)], dtype=np.int32)


def vert_scan(size: int) -> np.ndarray:
    return np.array([(x, y) for x in range(size) for y in range(size)], dtype=np.int32)


def scan_order(scan_idx: int, size: int) -> np.ndarray:
    return [diag_scan, horiz_scan, vert_scan][scan_idx](size)


def residual_scan_idx(pred_mode_intra: int | None, log2_size: int, c_idx: int) -> int:
    """Scan selection (7.4.9.11): mode-dependent only for small intra TBs."""
    if pred_mode_intra is not None and (
        log2_size == 2 or (log2_size == 3 and c_idx == 0)
    ):
        if 6 <= pred_mode_intra <= 14:
            return SCAN_VERT
        if 22 <= pred_mode_intra <= 30:
            return SCAN_HORIZ
    return SCAN_DIAG


def sub_block_scan(log2_size: int, scan_idx: int = SCAN_DIAG) -> np.ndarray:
    """Scan order of 4x4 coefficient groups within a TB."""
    n = 1 << (log2_size - 2)
    return scan_order(scan_idx, n)


# ------------------------------------------------------------- intra tables

# intraPredAngle for modes 2..34 (Table 8-5); index by mode-2
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)
# invAngle for modes 11..25 (Table 8-6); index by mode-11
INTRA_INV_ANGLE = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096],
    dtype=np.int32,
)


def intra_hor_ver_dist_thres(n_tbs: int) -> int:
    """Reference-sample smoothing threshold (8.4.4.2.3)."""
    return {8: 7, 16: 1, 32: 0}.get(n_tbs, 1 << 30)  # 4x4: never filtered
