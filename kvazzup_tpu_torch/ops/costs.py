"""Float32 cost arithmetic evaluated the way the reference's compiled CPU
program evaluates it.

The encoder's decisions compare float32 costs (SATD + lambda * bits, RD
sums), so a last-bit difference can flip a choice and change the stream.
Three properties of the reference's CPU compilation (XLA) matter, each
checked element for element against it in tests/test_torch_ops.py:

* `log` is a Cephes-style polynomial with fused multiply-adds, not the C
  library's `logf`; `2 * log2(x) + 1` is folded to `fma(log(x), 2/ln 2, 1)`.
  The bit estimates only ever take integer arguments, so `bits_of`
  evaluates that polynomial once on the host for 0..32768 and the device
  indexes the table (identical on every device, no device `log`).
* `a + b * c` inside one fused kernel becomes a single fused multiply-add
  (`fma`, emulated in float64 with the sum rounded to odd, so that the
  final rounding to float32 is the only one).
* the 256- and 1024-term row sums of the intra rate estimate are split
  into 32-term windows, each summed in order, then the partials in order
  (`bits_row_sum`).
* `exp2(x)` is `exp(x * ln 2)` by a Cephes-style polynomial with fused
  multiply-adds (`exp_f32`), so 2^k for an integer k is not exact: it is
  one or two ulp off for most k >= 13 (`exp2_int`, the RDOQ step size).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..runtime import device_const

TABLE_MAX = 32768  # |level| <= 32767, so |level| + 1 <= 32768

_CEPHES_P = [7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
             -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
             2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1]


def _f32(x):
    return np.asarray(x, np.float32)


def _fma_np(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def log_f32(x) -> np.ndarray:
    """Natural log of positive normal float32 values, rounded as the
    reference's CPU program rounds it."""
    x = _f32(x)
    bits = x.view(np.int32)
    e = ((bits >> 23) - 0x7F).astype(np.float32) + np.float32(1.0)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(np.float32)
    below = m < np.float32(0.707106781186547524)
    tmp = np.where(below, m, np.float32(0.0))
    m = m - np.float32(1.0)
    e = e - np.where(below, np.float32(1.0), np.float32(0.0))
    m = m + tmp
    p = [np.float32(c) for c in _CEPHES_P]
    x2 = m * m
    x3 = x2 * m
    y = _fma_np(p[0], m, p[1])
    y1 = _fma_np(p[3], m, p[4])
    y2 = _fma_np(p[6], m, p[7])
    y = _fma_np(y, m, p[2])
    y1 = _fma_np(y1, m, p[5])
    y2 = _fma_np(y2, m, p[8])
    y = _fma_np(y, x3, y1)
    y = _fma_np(y, x3, y2)
    y = _fma_np(y, x3, e * np.float32(-2.12194440e-4))
    m = m - x2 * np.float32(0.5)
    m = m + y
    return (m + e * np.float32(0.693359375)).astype(np.float32)


_CEPHES_EXP_P = [1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
                 1.6666665459E-1, 5.0000001201E-1]
EXP2_MAX = 63  # exp2_int covers 0..EXP2_MAX


def exp_f32(x) -> np.ndarray:
    """e^x of float32 values, rounded as the reference's CPU program
    rounds it: n = floor(x log2(e) + 1/2), r = x - n ln 2 in two steps,
    a degree-6 polynomial in fused multiply-adds, times 2^n."""
    x = np.clip(_f32(x), np.float32(-87.8), np.float32(88.8))
    n = np.floor(_fma_np(x, np.float32(1.44269504088896341), np.float32(0.5)))
    n = np.clip(n, np.float32(-127), np.float32(127)).astype(np.float32)
    r = _fma_np(-n, np.float32(0.693359375), x)
    r = _fma_np(-n, np.float32(-2.12194440e-4), r)
    p = [np.float32(c) for c in _CEPHES_EXP_P]
    z = _fma_np(r, p[0], p[1])
    for c in p[2:]:
        z = _fma_np(z, r, c)
    z = _fma_np(z, (r * r).astype(np.float32), r)
    z = (np.float32(1.0) + z).astype(np.float32)
    return (z * np.ldexp(np.float32(1.0), n.astype(np.int32))).astype(np.float32)


def exp2_int(k):
    """exp2(float32(k)) for an integer tensor k in 0..EXP2_MAX as the
    reference's program evaluates it: e^(k * ln 2) with ln 2 rounded to
    float32 (a table, identical on every device)."""
    t = device_const("exp2_table", lambda: exp_f32(
        np.arange(EXP2_MAX + 1, dtype=np.float32) * np.float32(0.693147182)),
        k.device, torch.float32)
    return t[k.long()]


@functools.lru_cache(maxsize=None)
def _bits_table_np(add: float = 1.0) -> np.ndarray:
    """t[v] = 2 * log2(v) + add for v = 1..TABLE_MAX (t[0] is unused)."""
    v = np.arange(1, TABLE_MAX + 1, dtype=np.float32)
    ln2 = log_f32(np.float32(2.0))
    two_over_ln2 = np.float32(2.0) * (np.float32(1.0) / ln2)
    t = _fma_np(log_f32(v), two_over_ln2, np.float32(add))
    return np.concatenate([np.ones(1, np.float32), t])


def bits_of(v):
    """2 * log2(|v| + 1) + 1 as float32 for an integer tensor v (the
    exp-Golomb-like length estimate of MV components and levels)."""
    t = device_const("bits_table", _bits_table_np, v.device, torch.float32)
    idx = (v.abs().long() + 1).clamp(max=TABLE_MAX)
    return t[idx]


def level_rate(v):
    """RDOQ's rate of a level: 0 for v = 0, else bits_of(v) + 1 (the
    significance flag).  The reference's program folds the two + 1s into
    one constant: fma(log(|v| + 1), 2 / ln 2, 2), a single rounding."""
    t = device_const("level_rate_table", lambda: _bits_table_np(2.0), v.device, torch.float32)
    idx = (v.abs().long() + 1).clamp(max=TABLE_MAX)
    return torch.where(v == 0, 0.0, t[idx])


def fma(a, b, c):
    """float32 a * b + c with a single rounding (a, c float32 tensors; b a
    float32 tensor or a Python number exact in float32).

    The product is exact in float64, but the float64 sum can round once more
    and land on a float32 rounding midpoint.  So the sum is rounded to odd
    (an inexact result takes the float64 neighbour with an odd last bit),
    and a float64 value rounded to odd rounds to float32 exactly as the true
    sum would (53 >= 2 * 24 + 2 bits)."""
    d = torch.float64
    p = a.to(d) * (b.to(d) if torch.is_tensor(b) else b)
    c = c.to(d)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)  # TwoSum: s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.full_like(s, math.inf).copysign(err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def bits_row_sum(lev):
    """Sum over the last dim (256 or 1024) of where(lev != 0, bits_of(lev),
    0), in the reference's order: in-order 32-term window sums, then the
    window partials in order."""
    k = lev.shape[-1]
    if k not in (256, 1024):
        raise ValueError(f"bits_row_sum expects 256 or 1024 terms, got {k}")
    terms = torch.where(lev != 0, bits_of(lev), 0.0)
    w = terms.reshape(lev.shape[:-1] + (k // 32, 32))
    part = w[..., 0]
    for i in range(1, 32):
        part = part + w[..., i]
    total = part[..., 0]
    for i in range(1, k // 32):
        total = total + part[..., i]
    return total
