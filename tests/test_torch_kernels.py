"""The port's hand-kernel wrappers (kvazzup_tpu_torch/ops/hopper_q.py and
the SAO wrapper in ops/sao.py).

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
from kvazzup_tpu_torch.ops import sao


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
    for log2 in (2, 3, 4, 5):
        k = 1 << (2 * log2)
        a = T(rng.integers(0, 256, (350, k)).astype(np.int32))
        b = T(rng.integers(0, 256, (10, k)).astype(np.int32))
        got = thq.satd_rows(a.to(dev), b.to(dev), log2, group=35)
        assert torch.equal(got.cpu(), thq.satd_rows_plain(a, b, log2, group=35))


@pytest.mark.cuda
def test_sao_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    # CTB-aligned luma and chroma planes, and a ragged one (partial CTBs)
    for ctb, h, w in ((16, 64, 96), (8, 32, 48), (16, 70, 100)):
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
