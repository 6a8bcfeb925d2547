"""HEVC slice-data syntax: binarization + context derivation (7.3.8, 9.3).

Drives the CABAC engine in both directions.  `residual_coding` implements
the full transform-coefficient syntax (7.3.8.11) for any TB size / scan;
the CU layer currently covers the intra tool-set the encoder emits
(CU == CTB, one TU per CU).  Pure host code operating on numpy arrays that
the device scan produced (encode) or that feed the device reconstruction
(decode) — the TPU/host seam of SURVEY.md §7 step 3.
"""

from __future__ import annotations

import numpy as np

from ..core import tables
from ..core.tables import SCAN_DIAG, SCAN_VERT
from .cabac import (
    CabacDecoder,
    CabacEncoder,
    decode_coeff_remaining,
    encode_coeff_remaining,
)
from .cabac_tables import OFFSETS

# 4x4 significance context map (9.3.4.2.5)
_CTX_IDX_MAP_4x4 = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]


def _last_prefix_ctx(log2: int, c_idx: int, bin_idx: int) -> int:
    if c_idx == 0:
        offset = 3 * (log2 - 2) + ((log2 - 1) >> 2)
        shift = (log2 + 1) >> 2
    else:
        offset = 15
        shift = log2 - 2
    return (bin_idx >> shift) + offset


def _sig_ctx(log2: int, c_idx: int, scan_idx: int, xc: int, yc: int, csbf: np.ndarray) -> int:
    if log2 == 2:
        sig = _CTX_IDX_MAP_4x4[(yc << 2) + xc]
    elif xc + yc == 0:
        sig = 0
    else:
        xs, ys = xc >> 2, yc >> 2
        nsb = (1 << (log2 - 2)) - 1
        prev = 0
        if xs < nsb:
            prev += int(csbf[ys, xs + 1])
        if ys < nsb:
            prev += 2 * int(csbf[ys + 1, xs])
        xp, yp = xc & 3, yc & 3
        if prev == 0:
            sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if xs + ys > 0:
                sig += 3
            sig += (9 if scan_idx == SCAN_DIAG else 15) if log2 == 3 else 21
        else:
            sig += 9 if log2 == 3 else 12
    return OFFSETS["sig_coeff_flag"] + sig + (27 if c_idx else 0)


def encode_residual(
    enc: CabacEncoder,
    coeffs: np.ndarray,
    log2: int,
    c_idx: int,
    scan_idx: int = SCAN_DIAG,
) -> None:
    """residual_coding(x0, y0, log2TrafoSize, cIdx) — encode side.

    coeffs: (N, N) int array indexed [y][x]; must contain >= 1 nonzero
    (cbf implies nonzero).
    """
    n = 1 << log2
    pos_scan = tables.scan_order(scan_idx, 4)
    sb_scan = tables.scan_order(scan_idx, max(1, n >> 2))
    nsb = len(sb_scan)

    # locate last significant coefficient in scan order
    last_pos = -1
    for i in range(nsb):
        sx, sy = sb_scan[i]
        for k in range(16):
            px, py = pos_scan[k]
            if coeffs[(sy << 2) + py, (sx << 2) + px]:
                last_pos = i * 16 + k
    assert last_pos >= 0, "encode_residual requires a nonzero block"
    last_sb, last_scan = last_pos >> 4, last_pos & 15
    lsx, lsy = sb_scan[last_sb]
    lpx, lpy = pos_scan[last_scan]
    last_x = (lsx << 2) + lpx
    last_y = (lsy << 2) + lpy
    if scan_idx == SCAN_VERT:
        last_x, last_y = last_y, last_x

    _encode_last_xy(enc, last_x, last_y, log2, c_idx)

    csbf = np.zeros((max(1, n >> 2), max(1, n >> 2)), dtype=np.int32)
    for i in range(nsb):
        sx, sy = sb_scan[i]
        block = coeffs[(sy << 2) : (sy << 2) + 4, (sx << 2) : (sx << 2) + 4]
        csbf[sy, sx] = 1 if np.any(block) else 0
    csbf[lsy, lsx] = 1

    prev_c1 = 1
    for i in range(last_sb, -1, -1):
        sx, sy = sb_scan[i]
        infer_sb_dc = 0
        coded_flag = int(csbf[sy, sx])
        if 0 < i < last_sb:
            ctx = 0
            nsb1 = csbf.shape[0] - 1
            if sx < nsb1:
                ctx += int(csbf[sy, sx + 1])
            if sy < nsb1:
                ctx += int(csbf[sy + 1, sx])
            ctx_inc = OFFSETS["coded_sub_block_flag"] + min(ctx, 1) + (2 if c_idx else 0)
            enc.encode_bin(ctx_inc, coded_flag)
            infer_sb_dc = 1
        else:
            coded_flag = 1
            csbf[sy, sx] = 1
        if not coded_flag:
            continue

        # significance map
        sig = np.zeros(16, dtype=np.int32)
        levels = np.zeros(16, dtype=np.int64)
        for k in range(16):
            px, py = pos_scan[k]
            levels[k] = coeffs[(sy << 2) + py, (sx << 2) + px]
            sig[k] = 1 if levels[k] else 0
        start = last_scan - 1 if i == last_sb else 15
        if i == last_sb:
            sig[last_scan] = 1  # implicit
        for k in range(start, -1, -1):
            if k > 0 or not infer_sb_dc:
                px, py = pos_scan[k]
                xc, yc = (sx << 2) + px, (sy << 2) + py
                enc.encode_bin(_sig_ctx(log2, c_idx, scan_idx, xc, yc, csbf), int(sig[k]))
                if sig[k]:
                    infer_sb_dc = 0
            else:
                # explicitly-flagged subblock with no earlier significance:
                # sig of the DC position is inferred to 1 by the decoder
                assert sig[0] == 1, "inferred-DC subblock must have nonzero DC"
        prev_c1 = _encode_sb_levels(enc, sig, levels, i, last_sb, last_scan, c_idx, prev_c1)


def _encode_last_xy(enc: CabacEncoder, last_x: int, last_y: int, log2: int, c_idx: int) -> None:
    cmax = (log2 << 1) - 1
    pref_x = _last_prefix(last_x)
    pref_y = _last_prefix(last_y)
    base = OFFSETS["last_sig_coeff_x_prefix"]
    for b in range(pref_x):
        enc.encode_bin(base + _last_prefix_ctx(log2, c_idx, b), 1)
    if pref_x < cmax:
        enc.encode_bin(base + _last_prefix_ctx(log2, c_idx, pref_x), 0)
    base = OFFSETS["last_sig_coeff_y_prefix"]
    for b in range(pref_y):
        enc.encode_bin(base + _last_prefix_ctx(log2, c_idx, b), 1)
    if pref_y < cmax:
        enc.encode_bin(base + _last_prefix_ctx(log2, c_idx, pref_y), 0)
    if pref_x > 3:
        nbits = (pref_x >> 1) - 1
        enc.encode_bypass_bits(last_x - ((2 + (pref_x & 1)) << nbits), nbits)
    if pref_y > 3:
        nbits = (pref_y >> 1) - 1
        enc.encode_bypass_bits(last_y - ((2 + (pref_y & 1)) << nbits), nbits)


def _last_prefix(v: int) -> int:
    """Map coordinate to its TR prefix value (inverse of group bases)."""
    if v < 4:
        return v
    # groups: prefix p>=4 covers [ (2+(p&1)) << ((p>>1)-1) , ... )
    p = 4
    while True:
        nbits = (p >> 1) - 1
        base = (2 + (p & 1)) << nbits
        if v < base + (1 << nbits):
            return p
        p += 1


def _encode_sb_levels(
    enc: CabacEncoder,
    sig: np.ndarray,
    levels: np.ndarray,
    i: int,
    last_sb: int,
    last_scan: int,
    c_idx: int,
    prev_c1: int,
) -> int:
    """greater1/greater2/sign/remaining for one coded subblock; returns c1."""
    sig_pos = [k for k in range(15, -1, -1) if sig[k]]
    if i == last_sb:
        sig_pos = [k for k in sig_pos if k <= last_scan]
    if not sig_pos:
        return prev_c1
    ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if prev_c1 == 0 else 0)
    c1 = 1
    g1_base = OFFSETS["coeff_abs_level_greater1_flag"] + (16 if c_idx else 0)
    g2_base = OFFSETS["coeff_abs_level_greater2_flag"] + (4 if c_idx else 0)
    num_g1 = min(8, len(sig_pos))
    g1_flags = {}
    first_g1_pos = -1
    for idx, k in enumerate(sig_pos[:num_g1]):
        absl = abs(int(levels[k]))
        flag = 1 if absl > 1 else 0
        enc.encode_bin(g1_base + ctx_set * 4 + c1, flag)
        g1_flags[k] = flag
        if flag:
            if first_g1_pos < 0:
                first_g1_pos = k
            c1 = 0
        elif 0 < c1 < 3:
            c1 += 1
    g2_flag = {}
    if first_g1_pos >= 0:
        absl = abs(int(levels[first_g1_pos]))
        flag = 1 if absl > 2 else 0
        enc.encode_bin(g2_base + ctx_set, flag)
        g2_flag[first_g1_pos] = flag
    # signs (no sign-data-hiding)
    for k in sig_pos:
        enc.encode_bypass(1 if levels[k] < 0 else 0)
    # remaining levels
    rice = 0
    for idx, k in enumerate(sig_pos):
        absl = abs(int(levels[k]))
        base_level = 1 + g1_flags.get(k, 0) + g2_flag.get(k, 0)
        saturated = (
            (idx >= 8)
            or (g1_flags.get(k, 0) == 1 and k not in g2_flag)
            or g2_flag.get(k, 0) == 1
        )
        if saturated:
            encode_coeff_remaining(enc, absl - base_level, rice)
            if absl > (3 << rice):
                rice = min(rice + 1, 4)
        else:
            assert absl == base_level, (absl, base_level)
    return c1


def decode_residual(
    dec: CabacDecoder,
    log2: int,
    c_idx: int,
    scan_idx: int = SCAN_DIAG,
    sdh: bool = False,
    tskip: bool = False,
) -> np.ndarray:
    """residual_coding — decode side; returns (N, N) int32 [y][x].

    tskip=True: PPS transform_skip is enabled and this is a 4x4 TB, so
    transform_skip_flag is the first element (7.3.8.11); the return
    becomes (coeffs, transform_skip_flag)."""
    nr = getattr(dec, "next_residual", None)
    if nr is not None:  # replay from the native parser's record
        return nr(log2, c_idx, tskip)
    ts_flag = False
    if tskip:
        ts_flag = bool(dec.decode_bin(
            OFFSETS["transform_skip_flag"] + (0 if c_idx == 0 else 1)))
    n = 1 << log2
    pos_scan = tables.scan_order(scan_idx, 4)
    sb_scan = tables.scan_order(scan_idx, max(1, n >> 2))
    coeffs = np.zeros((n, n), dtype=np.int32)

    cmax = (log2 << 1) - 1
    base = OFFSETS["last_sig_coeff_x_prefix"]
    pref_x = 0
    while pref_x < cmax and dec.decode_bin(base + _last_prefix_ctx(log2, c_idx, pref_x)):
        pref_x += 1
    base = OFFSETS["last_sig_coeff_y_prefix"]
    pref_y = 0
    while pref_y < cmax and dec.decode_bin(base + _last_prefix_ctx(log2, c_idx, pref_y)):
        pref_y += 1
    if pref_x > 3:
        nbits = (pref_x >> 1) - 1
        last_x = ((2 + (pref_x & 1)) << nbits) + dec.decode_bypass_bits(nbits)
    else:
        last_x = pref_x
    if pref_y > 3:
        nbits = (pref_y >> 1) - 1
        last_y = ((2 + (pref_y & 1)) << nbits) + dec.decode_bypass_bits(nbits)
    else:
        last_y = pref_y
    if scan_idx == SCAN_VERT:
        last_x, last_y = last_y, last_x

    # find (last_sb, last_scan) from coordinates
    last_pos = None
    for i in range(len(sb_scan)):
        sx, sy = sb_scan[i]
        for k in range(16):
            px, py = pos_scan[k]
            if (sx << 2) + px == last_x and (sy << 2) + py == last_y:
                last_pos = i * 16 + k
    assert last_pos is not None
    last_sb, last_scan = last_pos >> 4, last_pos & 15

    csbf = np.zeros((max(1, n >> 2), max(1, n >> 2)), dtype=np.int32)
    prev_c1 = 1
    for i in range(last_sb, -1, -1):
        sx, sy = sb_scan[i]
        infer_sb_dc = 0
        if 0 < i < last_sb:
            ctx = 0
            nsb1 = csbf.shape[0] - 1
            if sx < nsb1:
                ctx += int(csbf[sy, sx + 1])
            if sy < nsb1:
                ctx += int(csbf[sy + 1, sx])
            ctx_inc = OFFSETS["coded_sub_block_flag"] + min(ctx, 1) + (2 if c_idx else 0)
            coded_flag = dec.decode_bin(ctx_inc)
            infer_sb_dc = 1
        else:
            coded_flag = 1
        csbf[sy, sx] = coded_flag
        if not coded_flag:
            continue

        sig = np.zeros(16, dtype=np.int32)
        start = last_scan - 1 if i == last_sb else 15
        if i == last_sb:
            sig[last_scan] = 1
        for k in range(start, -1, -1):
            px, py = pos_scan[k]
            xc, yc = (sx << 2) + px, (sy << 2) + py
            if k > 0 or not infer_sb_dc:
                sig[k] = dec.decode_bin(_sig_ctx(log2, c_idx, scan_idx, xc, yc, csbf))
                if sig[k]:
                    infer_sb_dc = 0
            else:
                sig[0] = 1  # inferred
        prev_c1 = _decode_sb_levels(
            dec, sig, coeffs, pos_scan, sx, sy, i, last_sb, last_scan, c_idx, prev_c1,
            sdh,
        )
    return (coeffs, ts_flag) if tskip else coeffs


def _decode_sb_levels(
    dec, sig, coeffs, pos_scan, sx, sy, i, last_sb, last_scan, c_idx, prev_c1,
    sdh: bool = False,
) -> int:
    sig_pos = [k for k in range(15, -1, -1) if sig[k]]
    if i == last_sb:
        sig_pos = [k for k in sig_pos if k <= last_scan]
    if not sig_pos:
        return prev_c1
    ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if prev_c1 == 0 else 0)
    c1 = 1
    g1_base = OFFSETS["coeff_abs_level_greater1_flag"] + (16 if c_idx else 0)
    g2_base = OFFSETS["coeff_abs_level_greater2_flag"] + (4 if c_idx else 0)
    num_g1 = min(8, len(sig_pos))
    g1_flags = {}
    first_g1_pos = -1
    for idx, k in enumerate(sig_pos[:num_g1]):
        flag = dec.decode_bin(g1_base + ctx_set * 4 + c1)
        g1_flags[k] = flag
        if flag:
            if first_g1_pos < 0:
                first_g1_pos = k
            c1 = 0
        elif 0 < c1 < 3:
            c1 += 1
    g2_flag = {}
    if first_g1_pos >= 0:
        g2_flag[first_g1_pos] = dec.decode_bin(g2_base + ctx_set)
    # sign data hiding (7.3.8.11): when enabled and the sub-block spans
    # more than 3 scan positions, the sign of the coefficient at
    # firstSigScanPos is inferred from the parity of the level sum
    sign_hidden = sdh and (sig_pos[0] - sig_pos[-1] > 3)
    coded_signs = sig_pos[:-1] if sign_hidden else sig_pos
    signs = {k: dec.decode_bypass() for k in coded_signs}
    rice = 0
    abs_levels = {}
    for idx, k in enumerate(sig_pos):
        base_level = 1 + g1_flags.get(k, 0) + g2_flag.get(k, 0)
        saturated = (
            (idx >= 8)
            or (g1_flags.get(k, 0) == 1 and k not in g2_flag)
            or g2_flag.get(k, 0) == 1
        )
        absl = base_level
        if saturated:
            absl = base_level + decode_coeff_remaining(dec, rice)
            if absl > (3 << rice):
                rice = min(rice + 1, 4)
        abs_levels[k] = absl
    if sign_hidden:
        signs[sig_pos[-1]] = sum(abs_levels.values()) & 1
    for k in sig_pos:
        px, py = pos_scan[k]
        absl = abs_levels[k]
        coeffs[(sy << 2) + py, (sx << 2) + px] = -absl if signs[k] else absl
    return c1
