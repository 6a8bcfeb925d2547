"""Hand-written Hopper kernels for quant, dequant, SATD and the fused
residual chain, with their plain PyTorch versions.

Counterpart of `kvazzup_tpu/ops/pallas_q.py` (the three Pallas kernels of
the encode paths).  The CUDA sources are `csrc/q_kernels.cu` (SATD,
quant, dequant) and `csrc/resid_kernels.cu` (transform, quant, dequant,
inverse transform and reconstruction of 8x8 and 16x16 blocks in one
launch), built by `runtime.build_kernels`.  `code_residual_rows` /
`code_residual_planes` route each plane by its block size: 8x8 and 16x16
blocks through the fused kernel (all such planes of a call in one
launch), 32x32 blocks (the CTB64 path's TU32s) through the matmul
transforms around the `kvz_quant` and `kvz_dequant` launches.  With
`rdoq=True` every block size takes the matmul chain with the plain
`quant.rdoq_rows` in place of the quant kernel, and the `kvz_dequant`
launch (the fused kernel has no RDOQ).

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
from . import ctu_kernels as ck
from . import quant as _quant
from .satd import _satd_tile

LAUNCHES = {"quant": 0, "dequant": 0, "satd": 0, "residual": 0}
RESIDUAL_MAX_SAMPLES = 512  # per row over the planes of one launch (its threads)
FUSED_LOG2 = (3, 4)  # block sizes of the fused residual kernel; 5 takes quant + dequant


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


def _residual_chain(orig, pred, qp, intra, log2: int, bd: int, group: int, quant, dequant):
    """Forward transform -> quant -> dequant -> inverse transform -> recon
    with the given quant / dequant row functions (plain or kernel)."""
    if group > 1:
        orig, qp = orig.repeat_interleave(group, 0), qp.repeat_interleave(group)
        if torch.is_tensor(intra):
            intra = intra.repeat_interleave(group)
    if torch.is_tensor(intra):
        dz = torch.where(intra, 171, 85).to(torch.int32)
    else:
        dz = torch.full_like(qp, 171 if intra else 85)
    coef = ck.fwd_transform_flat(orig - pred, log2, bd=bd)
    lev = quant(coef, qp, dz, log2, bd)
    res = ck.inv_transform_flat(dequant(lev, qp, log2, bd), log2, bd=bd)
    return lev, (pred + res).clamp(0, (1 << bd) - 1)


def code_residual_rows_plain(orig, pred, qp, intra, log2: int, bd: int = 8,
                            group: int = 1):
    """Forward transform -> quant -> dequant -> inverse transform -> recon.

    pred (R, N^2) int32; orig (R / group, N^2) int32 and qp (R / group,)
    int32 pair with rows r of pred with r // group; intra is a bool for
    every row or an (R / group,) bool tensor.  Returns (levels, recon),
    both (R, N^2) int32."""
    return _residual_chain(orig, pred, qp, intra, log2, bd, group, quantize_rows_plain,
                           dequantize_rows_plain)


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
    with runtime.on_device(coef):
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
    with runtime.on_device(lev):
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
    if log2 not in (2, 3, 4, 5, 6):
        raise ValueError(f"satd: log2 must be 2..6, got {log2}")
    runtime.check_operand(a, "a", 2)
    rows = a.shape[0]
    if group < 1 or rows % group:
        raise ValueError(f"satd: {rows} rows do not split into groups of {group}")
    runtime.check_operand(a, "a", 2, (rows, n2))
    runtime.check_operand(b, "b", 2, (rows // group, n2))
    if not runtime.kernel_route(a, b):
        return satd_rows_plain(a, b, log2, group)
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("satd: the kernel's vector loads need 16-byte aligned operands")
    out = torch.empty((rows,), dtype=torch.int32, device=a.device)
    with runtime.on_device(a):
        err = runtime.kernel_lib().kvz_satd(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, group, log2,
            runtime.stream_ptr(a))
    runtime.check_launch(err, "satd")
    LAUNCHES["satd"] += 1
    return out


def _residual_plane(orig, pred, qp, log2: int, group: int, name: str, rows=None) -> int:
    """Check one plane's operands of the residual kernel, each once; its
    row count (`rows` when given, else pred's)."""
    if log2 not in (3, 4, 5):
        raise ValueError(f"residual {name}: log2 must be 3, 4 or 5, got {log2}")
    if rows is None:
        rows = pred.shape[0] if pred.ndim else 0
    n2 = 1 << (2 * log2)
    runtime.check_operand(pred, f"{name} pred", 2, (rows, n2))
    if group < 1 or rows % group:
        raise ValueError(f"residual {name}: {rows} rows do not split into groups of {group}")
    runtime.check_operand(orig, f"{name} orig", 2, (rows // group, n2))
    runtime.check_operand(qp, f"{name} qp", 1, (rows // group,))
    return rows


def _residual_intra(intra, groups: int, bd: int):
    """(flag tensor or None, scalar deadzone numerator) for the kernel."""
    if bd != 8:
        raise NotImplementedError(f"residual coding at bit depth {bd} is not ported (8 only)")
    if isinstance(intra, bool):
        return None, 171 if intra else 85
    runtime.check_operand(intra, "intra", 1, (groups,), dtype=torch.bool)
    return intra, 0


def _launch_residual(planes, flags, group: int, dz: int):
    """One kvz_code_residual launch over up to three planes, each (orig,
    pred, qp, lev, rec, rows, log2)."""
    pred = planes[0][1]
    args = []
    for o, p, q, lev, rec, rows, log2 in planes:
        args += [o.data_ptr(), p.data_ptr(), q.data_ptr(), lev.data_ptr(),
                 rec.data_ptr(), rows, log2]
    args += [None, None, None, None, None, 0, 0] * (3 - len(planes))
    with runtime.on_device(pred):
        err = runtime.kernel_lib().kvz_code_residual(
            *args, None if flags is None else flags.data_ptr(), group, dz,
            runtime.stream_ptr(pred))
    runtime.check_launch(err, "residual")
    LAUNCHES["residual"] += 1


def _check_lam2(lam2, rows: int):
    if lam2 is None:
        raise ValueError("residual: rdoq needs lam2, lambda^2 per row")
    runtime.check_operand(lam2, "lam2", 1, (rows,), dtype=torch.float32)


def _rdoq_chain(orig, pred, qp, intra, log2: int, group: int, lam2):
    """The RDOQ route: matmul transforms around `quant.rdoq_rows` and the
    dequant kernel (its plain version on a CPU tensor)."""
    lam2 = lam2.repeat_interleave(group) if group > 1 else lam2

    def rdoq(coef, q, dz, lg, bd):
        return _quant.rdoq_rows(coef, q, dz, lam2, lg, bd)

    return _residual_chain(orig, pred, qp, intra, log2, 8, group, rdoq, dequantize_rows)


def code_residual_rows(orig, pred, qp, intra, log2: int, bd: int = 8, group: int = 1, *,
                       rdoq: bool = False, lam2=None):
    """Residual coding of one plane: (levels, recon) of (R, N^2) int32
    predictions `pred` against `orig`, as `code_residual_rows_plain`.

    qp is (R / group,) int32; intra a bool (the deadzone of every row) or an
    (R / group,) bool tensor.  log2 is 3, 4 (one fused launch) or 5 (the
    32x32 route: one quant and one dequant launch), bd 8.  With `rdoq`,
    lam2 ((R / group,) float32, lambda^2) and the RDOQ route: one dequant
    launch."""
    rows = _residual_plane(orig, pred, qp, log2, group, "plane")
    flags, dz = _residual_intra(intra, rows // group, bd)
    if rdoq:
        _check_lam2(lam2, rows // group)
        return _rdoq_chain(orig, pred, qp, intra, log2, group, lam2)
    if not runtime.kernel_route(orig, pred, qp, *(() if flags is None else (flags,))):
        return code_residual_rows_plain(orig, pred, qp, intra, log2, bd, group)
    if log2 not in FUSED_LOG2:  # 32x32: the matmul transforms around two launches
        return _residual_chain(orig, pred, qp, intra, log2, bd, group, quantize_rows,
                               dequantize_rows)
    lev, rec = torch.empty_like(pred), torch.empty_like(pred)
    _launch_residual([(orig, pred, qp, lev, rec, rows, log2)], flags, group, dz)
    return lev, rec


def code_residual_planes(planes, intra, *, rdoq: bool = False, lam2=None):
    """Residual coding of up to three planes over the same R rows (a
    unit's luma, Cb and Cr): the 8x8 and 16x16 planes in one fused launch,
    each 32x32 plane through the quant + dequant route.  With `rdoq` (lam2
    (R,) float32, lambda^2 per row, shared by the planes) the planes of one
    block size go through the RDOQ route together: one dequant launch per
    block size.

    Each plane is (orig, pred, qp, log2), as for `code_residual_rows` with
    group 1; intra (a bool or an (R,) bool tensor) is shared by the planes.
    Returns [(levels, recon)] per plane, in order; the fused planes' are
    views of one int32 buffer."""
    rows = planes[0][1].shape[0] if planes[0][1].ndim else 0
    for k, (o, p, q, lg) in enumerate(planes):
        _residual_plane(o, p, q, lg, 1, f"plane {k}", rows)
    if rdoq:
        _check_lam2(lam2, rows)
        _residual_intra(intra, rows, 8)
        return _rdoq_planes(planes, intra, lam2, rows)
    fused = [k for k, (*_, lg) in enumerate(planes) if lg in FUSED_LOG2]
    n2s = [1 << (2 * planes[k][3]) for k in fused]
    if sum(n2s) > RESIDUAL_MAX_SAMPLES:
        raise ValueError(f"residual: more than {RESIDUAL_MAX_SAMPLES} samples per row")
    flags, dz = _residual_intra(intra, rows, 8)
    tensors = [t for o, p, q, _ in planes for t in (o, p, q)]
    if not runtime.kernel_route(*tensors, *(() if flags is None else (flags,))):
        return [code_residual_rows_plain(o, p, q, intra, lg) for o, p, q, lg in planes]
    outs = [None] * len(planes)
    if fused:
        buf = torch.empty(2 * rows * sum(n2s), dtype=torch.int32,
                          device=planes[0][1].device).split(
            [rows * n2 for n2 in n2s for _ in (0, 1)])
        for j, (k, n2) in enumerate(zip(fused, n2s)):
            outs[k] = (buf[2 * j].view(rows, n2), buf[2 * j + 1].view(rows, n2))
        _launch_residual([(*planes[k][:3], *outs[k], rows, planes[k][3]) for k in fused],
                         flags, 1, dz)
    for k, (o, p, q, lg) in enumerate(planes):
        if outs[k] is None:
            outs[k] = _residual_chain(o, p, q, intra, lg, 8, 1, quantize_rows, dequantize_rows)
    return outs


def _rdoq_planes(planes, intra, lam2, rows: int):
    """The RDOQ route of `code_residual_planes`: the planes of each block
    size stacked by rows through one chain (RDOQ is per row and per
    coefficient, so stacking changes no level)."""
    outs = [None] * len(planes)
    for lg in sorted({p[3] for p in planes}):
        ks = [k for k, p in enumerate(planes) if p[3] == lg]
        n = len(ks)
        o, p, q = (planes[ks[0]][j] if n == 1 else torch.cat([planes[k][j] for k in ks])
                   for j in range(3))
        flags = intra.repeat(n) if torch.is_tensor(intra) else intra
        lev, rec = _rdoq_chain(o, p, q, flags, lg, 1, lam2.repeat(n))
        for j, k in enumerate(ks):
            outs[k] = (lev[j * rows:(j + 1) * rows], rec[j * rows:(j + 1) * rows])
    return outs
