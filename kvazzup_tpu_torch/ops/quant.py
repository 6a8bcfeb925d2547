"""Scalar quantization: encoder quant (HM-compatible), normative dequant
and RDOQ (counterpart of kvazzup_tpu/ops/quant.py; flat scaling lists).

`quantize` / `dequantize` run the hand kernels of `hopper_q` on a CUDA
tensor, whatever its shape: coefficients are viewed as rows of the last
dimension, with qp (and the intra/inter deadzone) given per row.  The
encoder does not call these two: it quantizes inside the fused residual
kernel (`hopper_q.code_residual_rows` / `code_residual_planes`).

`quantize_rdoq` is plain PyTorch on every device, as the reference's RDOQ
runs outside its kernels.  The encoder reaches it through the RDOQ route
of `hopper_q.code_residual_rows` / `code_residual_planes` (`rdoq=True`):
transform, `rdoq_rows`, the dequant kernel, inverse transform.
"""

from __future__ import annotations

import torch

from ..core.tables import QUANT_SCALES
from . import costs, hopper_q


def _deadzone(intra, coef):
    """The deadzone numerator: 171 intra, 85 inter (a bool, or a bool
    array over coef's leading dims)."""
    if isinstance(intra, bool):
        return torch.full((), 171 if intra else 85, dtype=torch.int32, device=coef.device)
    return torch.where(torch.as_tensor(intra, device=coef.device), 171, 85)


def _per_row(v, coef, dtype=torch.int32):
    """Broadcast a scalar or leading-dims array to one value per row of
    `coef` (all dims but the last), flattened."""
    v = torch.as_tensor(v, dtype=dtype, device=coef.device)
    while v.ndim < coef.ndim - 1:
        v = v[..., None]
    return v.expand(coef.shape[:-1]).reshape(-1).contiguous()


def quantize(coef, qp, log2: int, intra=True, bd: int = 8):
    """Forward quantization of (..., N^2) int32 coefficients.

    qp: scalar or array over coef's leading dims; intra: bool or bool
    array over the leading dims (deadzone 171/512 intra, 85/512 inter)."""
    coef = coef.to(torch.int32).contiguous()
    k = coef.shape[-1]
    lev = hopper_q.quantize_rows(coef.reshape(-1, k), _per_row(qp, coef),
                                 _per_row(_deadzone(intra, coef), coef), log2, bd)
    return lev.reshape(coef.shape)


def dequantize(level, qp, log2: int, bd: int = 8):
    """Normative scaling (8.6.3) with flat lists (m = 16)."""
    level = level.to(torch.int32).contiguous()
    k = level.shape[-1]
    d = hopper_q.dequantize_rows(level.reshape(-1, k), _per_row(qp, level),
                                 log2, bd)
    return d.reshape(level.shape)


def rdoq_rows(coef, qp, dz, lam, log2: int, bd: int = 8):
    """RDOQ of (B, K) int32 coefficients: qp, dz (deadzone numerator 171 /
    85) (B,) int32, lam (B,) float32 (lambda^2) -> levels (B, K) int32.

    Per coefficient, the deadzone level l_dz against l_dz - 1 and, when
    l_dz <= 2, l_dz - 2 (floored at 0), by e^2 + lamq * rate with
    e = |c| Q - l step and lamq = lam Q^2 2^(30 - 2 bd - 2 log2), a strict
    `<`.  The float32 arithmetic is the reference program's (`costs`):
    step = exp2(qbits) by its polynomial, e = fma(-l, step, |c| Q) and the
    cost fma(e, e, lamq * rate), rate = level_rate(l)."""
    q = qp[:, None]
    per = torch.div(q, 6, rounding_mode="floor")
    rem = q - 6 * per
    qbits = 29 - bd + per - log2
    scale = hopper_q._table6("quant_scales", QUANT_SCALES, rem)
    num = coef.abs() * scale
    l_dz = (num + (dz[:, None] << (qbits - 9))) >> qbits
    numf = num.to(torch.float32)
    stepf = costs.exp2_int(qbits)
    scalef = scale.to(torch.float32)
    lamq = lam[:, None] * scalef * scalef * float(2.0 ** (30 - 2 * bd - 2 * log2))

    def cost(lev):
        e = costs.fma(-lev.to(torch.float32), stepf, numf)
        return costs.fma(e, e, lamq * costs.level_rate(lev))

    c_dz = cost(l_dz)
    l1 = (l_dz - 1).clamp(min=0)
    c1 = cost(l1)
    best = torch.where(c1 < c_dz, l1, l_dz)
    c_best = torch.where(c1 < c_dz, c1, c_dz)
    l2 = (l_dz - 2).clamp(min=0)
    best = torch.where((l_dz <= 2) & (cost(l2) < c_best), l2, best)
    best = best.clamp(0, 32767)
    return torch.where(coef < 0, -best, best)


def quantize_rdoq(coef, qp, log2: int, lam, intra=True, bd: int = 8):
    """Rate-distortion optimized quantization of (..., N^2) int32
    coefficients (the reference's RDOQ-lite): qp and lam (lambda^2, float32)
    scalars or arrays over coef's leading dims, intra a bool or a bool array
    over them (deadzone 171 / 85)."""
    coef = coef.to(torch.int32).contiguous()
    k = coef.shape[-1]
    lev = rdoq_rows(coef.reshape(-1, k), _per_row(qp, coef),
                    _per_row(_deadzone(intra, coef), coef),
                    _per_row(lam, coef, torch.float32), log2, bd)
    return lev.reshape(coef.shape)
