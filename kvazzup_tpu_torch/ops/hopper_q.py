"""Hand-written Hopper kernels for quant, dequant and SATD, with their plain
PyTorch versions.

Counterpart of `kvazzup_tpu/ops/pallas_q.py` (the three Pallas kernels of
the CTB16 path).  The CUDA sources are `csrc/q_kernels.cu`, built by
`runtime.build_kernels`.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (and raises if the library cannot be built or
the launch is refused).  There is no fallback between the two.

`LAUNCHES` counts kernel launches per kernel; the plain versions never
touch it.
"""

from __future__ import annotations

import torch

from .. import runtime
from ..core.tables import DEQUANT_SCALES, QUANT_SCALES
from .satd import _satd_tile

LAUNCHES = {"quant": 0, "dequant": 0, "satd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions


def _table6(name: str, table, rem):
    t = runtime.device_const(name, lambda: table, rem.device, torch.int32)
    return t[rem.long()]


def quantize_rows_plain(coef, qp, dz, log2: int, bd: int = 8):
    """coef (B, K) int32; qp, dz (B,) int32 -> levels (B, K) int32."""
    q = qp[:, None]
    per = torch.div(q, 6, rounding_mode="floor")
    rem = q - 6 * per
    qbits = 29 - bd + per - log2
    offset = dz[:, None] << (qbits - 9)
    mag = (coef.abs() * _table6("quant_scales", QUANT_SCALES, rem) + offset) >> qbits
    mag = mag.clamp(0, 32767)
    return torch.where(coef < 0, -mag, mag)


def dequantize_rows_plain(lev, qp, log2: int, bd: int = 8):
    """lev (B, K) int32; qp (B,) int32 -> scaled coefficients (B, K)."""
    q = qp[:, None]
    per = torch.div(q, 6, rounding_mode="floor")
    rem = q - 6 * per
    sh = bd + log2 - 5 - per
    x = lev * (_table6("dequant_scales", DEQUANT_SCALES, rem) * 16)
    rsh = sh.clamp(min=1)
    d_right = (x + (1 << (rsh - 1))) >> rsh
    d_left = x << (-sh).clamp(min=0)
    return torch.where(sh > 0, d_right, d_left).clamp(-32768, 32767)


def satd_rows_plain(a, b, log2: int, group: int = 1):
    """a (R, N^2), b (R / group, N^2) int32 -> (R,) int32 SATD.

    Per 8x8 subblock (4x4 when N = 4): 2-D Hadamard of the difference, sum
    of absolute values, (s + 2) >> 2 ((s + 1) >> 1 for 4x4); summed per row.
    """
    n = 1 << log2
    bs = min(8, n)
    rows = a.shape[0]
    bb = b.repeat_interleave(group, dim=0) if group > 1 else b
    d = (a - bb).reshape(rows, n // bs, bs, n // bs, bs).transpose(2, 3)
    return _satd_tile(d, bs).sum(dim=(1, 2)).to(torch.int32)


# ------------------------------------------------------------------ wrappers


def quantize_rows(coef, qp, dz, log2: int, bd: int = 8):
    """Quantize (B, K) int32 coefficients with per-row qp and deadzone
    numerator dz (171 intra / 85 inter)."""
    runtime.check_operand(coef, "coef", 2)
    rows, k = coef.shape
    runtime.check_operand(qp, "qp", 1, (rows,))
    runtime.check_operand(dz, "dz", 1, (rows,))
    if not runtime.kernel_route(coef, qp, dz):
        return quantize_rows_plain(coef, qp, dz, log2, bd)
    out = torch.empty_like(coef)
    with torch.cuda.device(coef.device):
        err = runtime.kernel_lib().kvz_quant(
            coef.data_ptr(), qp.data_ptr(), dz.data_ptr(), out.data_ptr(),
            rows, k, log2, bd, runtime.stream_ptr(coef))
    runtime.check_launch(err, "quant")
    LAUNCHES["quant"] += 1
    return out


def dequantize_rows(lev, qp, log2: int, bd: int = 8):
    """Dequantize (B, K) int32 levels with per-row qp."""
    runtime.check_operand(lev, "lev", 2)
    rows, k = lev.shape
    runtime.check_operand(qp, "qp", 1, (rows,))
    if not runtime.kernel_route(lev, qp):
        return dequantize_rows_plain(lev, qp, log2, bd)
    out = torch.empty_like(lev)
    with torch.cuda.device(lev.device):
        err = runtime.kernel_lib().kvz_dequant(
            lev.data_ptr(), qp.data_ptr(), out.data_ptr(), rows, k, log2, bd,
            runtime.stream_ptr(lev))
    runtime.check_launch(err, "dequant")
    LAUNCHES["dequant"] += 1
    return out


def satd_rows(a, b, log2: int, group: int = 1):
    """Hadamard SATD of (R, N^2) blocks against (R / group, N^2) blocks
    (row r of `a` pairs with row r // group of `b`)."""
    n2 = 1 << (2 * log2)
    if log2 not in (2, 3, 4, 5):
        raise ValueError(f"satd: log2 must be 2..5, got {log2}")
    runtime.check_operand(a, "a", 2)
    rows = a.shape[0]
    if group < 1 or rows % group:
        raise ValueError(f"satd: {rows} rows do not split into groups of {group}")
    runtime.check_operand(a, "a", 2, (rows, n2))
    runtime.check_operand(b, "b", 2, (rows // group, n2))
    if not runtime.kernel_route(a, b):
        return satd_rows_plain(a, b, log2, group)
    out = torch.empty((rows,), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = runtime.kernel_lib().kvz_satd(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, group, log2,
            runtime.stream_ptr(a))
    runtime.check_launch(err, "satd")
    LAUNCHES["satd"] += 1
    return out
