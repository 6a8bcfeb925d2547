"""Scalar quantization: encoder quant (HM-compatible) and normative dequant
(counterpart of kvazzup_tpu/ops/quant.py; flat scaling lists).

Every call runs the hand kernels of `hopper_q` on a CUDA tensor, whatever
its shape: coefficients are viewed as rows of the last dimension, with qp
(and the intra/inter deadzone) given per row.  RDOQ is not ported.  The
encoder does not call these: it quantizes inside the fused residual kernel
(`hopper_q.code_residual_rows` / `code_residual_planes`).
"""

from __future__ import annotations

import torch

from . import hopper_q


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
    if isinstance(intra, bool):
        dz = torch.full((), 171 if intra else 85, dtype=torch.int32, device=coef.device)
    else:
        dz = torch.where(torch.as_tensor(intra, device=coef.device), 171, 85)
    k = coef.shape[-1]
    lev = hopper_q.quantize_rows(coef.reshape(-1, k), _per_row(qp, coef),
                                 _per_row(dz, coef), log2, bd)
    return lev.reshape(coef.shape)


def dequantize(level, qp, log2: int, bd: int = 8):
    """Normative scaling (8.6.3) with flat lists (m = 16)."""
    level = level.to(torch.int32).contiguous()
    k = level.shape[-1]
    d = hopper_q.dequantize_rows(level.reshape(-1, k), _per_row(qp, level),
                                 log2, bd)
    return d.reshape(level.shape)
