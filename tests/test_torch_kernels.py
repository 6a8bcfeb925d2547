"""The port's hand-kernel wrappers (kvazzup_tpu_torch/ops/hopper_q.py, the
merge search in ops/merge.py and the SAO wrappers in ops/sao.py).

CPU: the wrappers take their plain PyTorch versions, validate their
operands and never count a launch.  GPU (`cuda` marker, skipped without a
card): each CUDA kernel equals its plain version element for element.
This file imports no JAX, so on a machine with a card and no JAX it runs
alone:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch

from kvazzup_tpu_torch.ops import hopper_q as thq
from kvazzup_tpu_torch.ops import merge, sao


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_wrappers_take_plain_path_on_cpu():
    thq.reset_launches()
    rng = np.random.default_rng(6)
    c = T(rng.integers(-999, 999, (4, 64)).astype(np.int32))
    q = T(np.full((4,), 30, np.int32))
    dz = T(np.full((4,), 171, np.int32))
    thq.quantize_rows(c, q, dz, 3)
    thq.dequantize_rows(c, q, 3)
    thq.satd_rows(c, c.flip(0).contiguous(), 3)
    thq.code_residual_rows(c, c.flip(0).contiguous(), q, True, 3)
    assert thq.LAUNCHES == {"quant": 0, "dequant": 0, "satd": 0, "residual": 0}
    with pytest.raises(TypeError):
        thq.quantize_rows(c.to(torch.int64), q, dz, 3)
    with pytest.raises(ValueError):
        thq.satd_rows(c, c[:2].contiguous(), 3)


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    for log2 in (3, 4, 5):
        k = 1 << (2 * log2)
        coef = T(rng.integers(-30000, 30000, (300, k)).astype(np.int32))
        qp = T(rng.integers(0, 52, (300,)).astype(np.int32))
        dz = T(np.where(rng.integers(0, 2, (300,)) > 0, 171, 85).astype(np.int32))
        got = thq.quantize_rows(coef.to(dev), qp.to(dev), dz.to(dev), log2)
        assert torch.equal(got.cpu(), thq.quantize_rows_plain(coef, qp, dz, log2))
        got = thq.dequantize_rows(coef.to(dev), qp.to(dev), log2)
        assert torch.equal(got.cpu(), thq.dequantize_rows_plain(coef, qp, log2))
    # every block size, with and without the broadcast original, at row
    # counts that leave a CTA or a warp part empty; extreme differences
    for log2 in (2, 3, 4, 5, 6):
        k = 1 << (2 * log2)
        for rows, group in ((350, 35), (350, 1), (33, 11), (1, 1)):
            a = T(rng.integers(0, 256, (rows, k)).astype(np.int32))
            b = T(rng.integers(0, 256, (rows // group, k)).astype(np.int32))
            if rows == 33:
                a[::2], b[::2] = 255, 0
            got = thq.satd_rows(a.to(dev), b.to(dev), log2, group=group)
            assert torch.equal(got.cpu(), thq.satd_rows_plain(a, b, log2, group=group))


@pytest.mark.cuda
def test_sao_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    # CTB-aligned luma and chroma planes, ragged ones (partial CTBs, widths
    # that are not whole 4-sample words, a plane narrower than one word)
    for ctb, h, w in ((16, 64, 96), (8, 32, 48), (16, 70, 100), (16, 37, 131), (8, 9, 3)):
        cbh, cbw = -(-h // ctb), -(-w // ctb)
        rec = T(rng.integers(0, 256, (h, w)).astype(np.uint8))
        typ = T(rng.integers(0, 3, (cbh, cbw)).astype(np.int32))
        aux = T(np.where(typ.numpy() == 2, rng.integers(0, 4, (cbh, cbw)),
                         rng.integers(0, 29, (cbh, cbw))).astype(np.int32))
        offs = T(rng.integers(-7, 8, (cbh, cbw, 4)).astype(np.int32))
        sao.reset_launches()
        got = sao.sao_apply(*(t.to(dev) for t in (rec, typ, aux, offs)), ctb=ctb)
        torch.cuda.synchronize()
        assert sao.LAUNCHES == {"sao": 1}
        assert torch.equal(got.cpu(), sao.sao_apply_plain(rec, typ, aux, offs, ctb=ctb))


def _sao_params(rng, h, w, ctb):
    cbh, cbw = -(-h // ctb), -(-w // ctb)
    typ = rng.integers(0, 3, (cbh, cbw)).astype(np.int32)
    aux = np.where(typ == 2, rng.integers(0, 4, (cbh, cbw)),
                   rng.integers(0, 32, (cbh, cbw))).astype(np.int32)
    offs = rng.integers(-7, 8, (cbh, cbw, 4)).astype(np.int32)
    return T(typ), T(aux), T(offs)


def _merge_mvs(rng, k_cands, lanes):
    """Quarter-pel MVs: every phase pair, -17 px reads outside the window,
    random ones far outside, and equal last two candidates (a tie)."""
    mvs = rng.integers(-80, 81, (k_cands, lanes, 2)).astype(np.int32)
    mvs[0, :, 0] = 4 * rng.integers(-17, 17, lanes) + np.arange(lanes) % 4
    mvs[0, :, 1] = 4 * rng.integers(-17, 17, lanes) + np.arange(lanes) // 4 % 4
    mvs[0, 1] = (-67, -66)
    if k_cands > 2:
        mvs[-2] = mvs[-1]
    return [T(m) for m in mvs]


def test_merge_and_sao_planes_take_plain_path_on_cpu():
    """On CPU tensors the merge search and the three-plane SAO wrapper run
    their plain versions and count no launch."""
    rng = np.random.default_rng(7)
    merge.reset_launches()
    sao.reset_launches()
    strips = T(rng.integers(0, 256, (4, 55, 90)).astype(np.uint8))
    oy_w = T(rng.integers(0, 256, (2, 4, 256)).astype(np.int32))
    lam_w = T(np.full((2, 4), 30.0, np.float32))
    ms = merge.MergeSearch(strips, oy_w, lam_w, 2)
    idx, cost, mv, pred = ms.wave(1, _merge_mvs(rng, 2, 4))
    assert (idx.shape, cost.dtype, mv.shape, pred.shape) == (
        (4,), torch.float32, (4, 2), (4, 256))
    planes = [(T(rng.integers(0, 256, (h, w)).astype(np.uint8)), *_sao_params(rng, h, w, c), c)
              for h, w, c in ((32, 48, 16), (16, 24, 8), (16, 24, 8))]
    outs = sao.sao_apply_planes(planes)
    for (rec, typ, aux, offs, ctb), out in zip(planes, outs):
        assert torch.equal(out, sao.sao_apply_plain(rec, typ, aux, offs, ctb=ctb))
    assert merge.LAUNCHES == {"merge": 0} and sao.LAUNCHES == {"sao": 0}
    with pytest.raises(ValueError):
        sao.sao_apply_planes(planes + planes[:1])
    with pytest.raises(ValueError):
        sao.sao_apply_planes([(*planes[0][:4], 2)])


@pytest.mark.cuda
def test_merge_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    lanes, nw = 20, 5
    strips = T(rng.integers(0, 256, (lanes, 55, 55 + 2 * 16 + 7)).astype(np.uint8))
    oy_w = T(rng.integers(0, 256, (nw, lanes, 256)).astype(np.int32))
    lam_w = T((rng.random((nw, lanes)) * 150).astype(np.float32))
    lam_w[:, ::3] = 0.0
    for k_cands in (1, 2, 3, 5):
        plain = merge.MergeSearch(strips, oy_w, lam_w, k_cands)
        merge.reset_launches()
        kern = merge.MergeSearch(strips.to(dev), oy_w.to(dev), lam_w.to(dev), k_cands)
        for d in range(nw):  # the last waves' window start is clamped
            cands = _merge_mvs(rng, k_cands, lanes)
            want = plain.wave(d, cands)
            got = kern.wave(d, [c.to(dev) for c in cands])
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
        assert merge.LAUNCHES == {"merge": nw}


@pytest.mark.cuda
def test_sao_three_plane_launch_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(24)
    for h, w in ((64, 96), (70, 102)):  # CTB-aligned, and ragged planes
        ch, cw = -(-h // 2), -(-w // 2)
        planes = [(T(rng.integers(0, 256, (ph, pw)).astype(np.uint8)),
                   *_sao_params(rng, ph, pw, c), c)
                  for ph, pw, c in ((h, w, 16), (ch, cw, 8), (ch, cw, 8))]
        sao.reset_launches()
        got = sao.sao_apply_planes([tuple(t.to(dev) for t in p[:4]) + (p[4],) for p in planes])
        torch.cuda.synchronize()
        assert sao.LAUNCHES == {"sao": 1}
        for (rec, typ, aux, offs, ctb), g in zip(planes, got):
            assert torch.equal(g.cpu(), sao.sao_apply_plain(rec, typ, aux, offs, ctb=ctb))


def test_quad_residual_routes_take_plain_path_on_cpu():
    """The CTB64 path's residual forms on the CPU: a TU32 plane and a
    unit's luma + Cb + Cr (32x32 + two 16x16) launch nothing, and equal
    the plain chain."""
    thq.reset_launches()
    rng = np.random.default_rng(8)
    planes = [(T(rng.integers(0, 256, (5, 1 << (2 * lg))).astype(np.int32)),
               T(rng.integers(0, 256, (5, 1 << (2 * lg))).astype(np.int32)),
               T(rng.integers(0, 52, (5,)).astype(np.int32)), lg) for lg in (5, 4, 4)]
    flags = T(rng.integers(0, 2, (5,)).astype(bool))
    got = thq.code_residual_planes(planes, flags)
    for (o, p, q, lg), (lev, rec) in zip(planes, got):
        want = thq.code_residual_rows_plain(o, p, q, flags, lg)
        assert torch.equal(lev, want[0]) and torch.equal(rec, want[1])
    assert thq.LAUNCHES == {"quant": 0, "dequant": 0, "satd": 0, "residual": 0}
    with pytest.raises(ValueError):  # three 16x16 planes: 768 samples a row
        thq.code_residual_planes([planes[1]] * 3, True)


@pytest.mark.cuda
def test_quad_residual_routes_match_plain_on_gpu():
    """TU32s through kvz_quant + kvz_dequant (intra flag per row and per
    call, group > 1), and one kvz_code_residual launch over two 16x16
    chroma planes (512 threads), element-identical to the plain chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    rows, group = 96, 3
    orig = T(rng.integers(0, 256, (rows // group, 1024)).astype(np.int32))
    pred = T(rng.integers(0, 256, (rows, 1024)).astype(np.int32))
    qp = T(rng.integers(0, 52, (rows // group,)).astype(np.int32))
    flags = T(rng.integers(0, 2, (rows // group,)).astype(bool))
    for intra in (True, False, flags):
        thq.reset_launches()
        got = thq.code_residual_rows(orig.to(dev), pred.to(dev), qp.to(dev),
                                     intra.to(dev) if torch.is_tensor(intra) else intra, 5,
                                     group=group)
        want = thq.code_residual_rows_plain(orig, pred, qp, intra, 5, group=group)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert thq.LAUNCHES == {"quant": 1, "dequant": 1, "satd": 0, "residual": 0}
    planes = [(T(rng.integers(0, 256, (40, 1 << (2 * lg))).astype(np.int32)),
               T(rng.integers(0, 256, (40, 1 << (2 * lg))).astype(np.int32)),
               T(rng.integers(0, 52, (40,)).astype(np.int32)), lg) for lg in (5, 4, 4)]
    flags = T(rng.integers(0, 2, (40,)).astype(bool))
    thq.reset_launches()
    got = thq.code_residual_planes([(o.to(dev), p.to(dev), q.to(dev), lg)
                                    for o, p, q, lg in planes], flags.to(dev))
    assert thq.LAUNCHES == {"quant": 1, "dequant": 1, "satd": 0, "residual": 1}
    for (o, p, q, lg), (lev, rec) in zip(planes, got):
        want = thq.code_residual_rows_plain(o, p, q, flags, lg)
        assert torch.equal(lev.cpu(), want[0]) and torch.equal(rec.cpu(), want[1])
