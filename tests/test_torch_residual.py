"""The port's fused residual coding (kvazzup_tpu_torch/ops/hopper_q.py
`code_residual_rows` / `code_residual_planes`, kernel `kvz_code_residual` in
csrc/resid_kernels.cu) against the JAX reference's chains.

The same seeded numpy inputs go through the reference and the port's plain
version, tolerance 0:
  * the IDR wave's chain, `kvazzup_tpu.encoder.frame_intra._code_flat_sel`
    with rdoq=False;
  * the P wave's chain with a per-row intra flag
    (`kvazzup_tpu/encoder/frame_inter.py`, `encode_frame_p_fast`);
  * the IDR mode prepass's chain over three candidates per original
    (`group=3`).
The extreme inputs (orig 255 against pred 0, the reverse, a +-255
checkerboard) reach the dequant's int16 clip and the recon clip; the
inverse transform's int16 clip lies out of reach of 8-bit residuals.
On the CPU the wrappers take the plain version.  The `cuda`-marked test
holds the kernel against it on the card, at the 1080p wave and prepass
shapes, and skips here.  The JAX reference is imported by a fixture, so on
a machine with a card and no JAX that test runs alone:

    python -m pytest tests/test_torch_residual.py -m cuda --noconftest -o addopts= -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kvazzup_tpu_torch.ops import hopper_q as thq


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: `code_flat_sel` and the P-wave chain."""
    import jax.numpy as jnp

    from kvazzup_tpu.encoder import frame_intra
    from kvazzup_tpu.ops import ctu_kernels as ck
    from kvazzup_tpu.ops import quant

    def code_flat_sel(orig, pred, qp, log2):
        lev, rec = frame_intra._code_flat_sel(ck, jnp.asarray(orig), jnp.asarray(pred),
                                              jnp.asarray(qp), log2, None, False)
        return np.asarray(lev), np.asarray(rec)

    def chain(orig, pred, qp, intra, log2):
        """The P wave's chain; orig broadcasts against pred."""
        orig, pred, qp = jnp.asarray(orig), jnp.asarray(pred), jnp.asarray(qp)
        intra = intra if isinstance(intra, bool) else jnp.asarray(intra)
        lev = quant.quantize(ck.fwd_transform_flat(orig - pred, log2), qp, log2, intra)
        res = ck.inv_transform_flat(quant.dequantize(lev, qp, log2), log2)
        return np.asarray(lev), np.asarray(jnp.clip(pred + res, 0, 255))

    return SimpleNamespace(code_flat_sel=code_flat_sel, chain=chain)


def _inputs(rng, rows, log2, kind, groups=None):
    """(orig (groups, N^2), pred (rows, N^2)) int32 samples in 0..255."""
    groups = rows if groups is None else groups
    k = 1 << (2 * log2)
    if kind == "random":
        orig = rng.integers(0, 256, (groups, k))
        pred = rng.integers(0, 256, (rows, k))
    elif kind == "orig255_pred0":
        orig, pred = np.full((groups, k), 255), np.zeros((rows, k))
    elif kind == "orig0_pred255":
        orig, pred = np.zeros((groups, k)), np.full((rows, k), 255)
    else:  # "checker": +-255 alternating, the largest coefficients
        orig = (np.indices((groups, k)).sum(0) % 2) * 255
        pred = 255 - np.repeat(orig, rows // groups, 0)
    return orig.astype(np.int32), pred.astype(np.int32)


def _qp(rng, rows, mode):
    if mode == "random":
        return rng.integers(0, 52, (rows,)).astype(np.int32)
    return np.full((rows,), mode, np.int32)


KINDS = ["random", "orig255_pred0", "orig0_pred255", "checker"]


def _eq(got, want):
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("log2", [3, 4])
@pytest.mark.parametrize("qp", [0, 51, "random"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_code_flat_sel(ref, log2, qp, kind):
    """The IDR wave's chain: every row intra, qp per row."""
    rng = np.random.default_rng(log2 * 100 + KINDS.index(kind))
    orig, pred = _inputs(rng, 12, log2, kind)
    q = _qp(rng, 12, qp)
    got = thq.code_residual_rows_plain(T(orig), T(pred), T(q), True, log2)
    _eq(got, ref.code_flat_sel(orig, pred, q, log2))


@pytest.mark.parametrize("log2", [3, 4])
@pytest.mark.parametrize("intra", ["inter", "mixed"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_p_chain(ref, log2, intra, kind):
    """The P wave's chain: deadzone 85 on inter rows, 171 on intra rows."""
    rng = np.random.default_rng(7 + log2 * 10 + KINDS.index(kind))
    orig, pred = _inputs(rng, 16, log2, kind)
    q = _qp(rng, 16, "random")
    flags = np.zeros(16, bool) if intra == "inter" else rng.integers(0, 2, 16).astype(bool)
    want = ref.chain(orig, pred, q, flags, log2)
    _eq(thq.code_residual_rows_plain(T(orig), T(pred), T(q), T(flags), log2), want)
    # the wrapper on CPU tensors is the plain version, bool or per-row flags
    _eq(thq.code_residual_rows(T(orig), T(pred), T(q), T(flags), log2), want)
    if intra == "inter":
        _eq(thq.code_residual_rows(T(orig), T(pred), T(q), False, log2), want)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_prepass_chain(ref, kind):
    """The IDR mode prepass: three candidate predictions per original,
    qp per original (group=3), against the reference's broadcast form."""
    rng = np.random.default_rng(31 + KINDS.index(kind))
    g = 10
    orig, pred = _inputs(rng, 3 * g, 4, kind, groups=g)
    q = _qp(rng, g, "random")
    lev, rec = ref.chain(orig[:, None, :], pred.reshape(g, 3, -1), q, True, 4)
    want = (lev.reshape(3 * g, -1), rec.reshape(3 * g, -1))
    _eq(thq.code_residual_rows(T(orig), T(pred), T(q), True, 4, group=3), want)
    flags = np.ones(g, bool)
    _eq(thq.code_residual_rows_plain(T(orig), T(pred), T(q), T(flags), 4, group=3), want)


def _wave(rng, lanes):
    planes = []
    for log2 in (4, 3, 3):
        orig, pred = _inputs(rng, lanes, log2, "random")
        planes.append((T(orig), T(pred), T(_qp(rng, lanes, "random")), log2))
    return planes


@pytest.mark.parametrize("intra", [True, False, "mixed"])
def test_wave_equals_three_plane_calls(intra):
    rng = np.random.default_rng(41)
    lanes = 9
    planes = _wave(rng, lanes)
    flags = T(rng.integers(0, 2, lanes).astype(bool)) if intra == "mixed" else intra
    thq.reset_launches()
    got = thq.code_residual_planes(planes, flags)
    assert len(got) == 3
    for (lev, rec), (o, p, q, log2) in zip(got, planes):
        want_lev, want_rec = thq.code_residual_rows(o, p, q, flags, log2)
        assert torch.equal(lev, want_lev) and torch.equal(rec, want_rec)
    assert thq.LAUNCHES["residual"] == 0


def test_wrappers_raise_on_bad_operands():
    rng = np.random.default_rng(5)
    o, p = (T(a) for a in _inputs(rng, 6, 3, "random"))
    q = T(_qp(rng, 6, "random"))
    with pytest.raises(TypeError):  # dtype
        thq.code_residual_rows(o, p.to(torch.int64), q, True, 3)
    with pytest.raises(TypeError):
        thq.code_residual_rows(o, p, q, T(np.ones(6, np.int32)), 3)
    with pytest.raises(ValueError):  # shape: orig rows, N^2, qp rows
        thq.code_residual_rows(o[:5].contiguous(), p, q, True, 3)
    with pytest.raises(ValueError):
        thq.code_residual_rows(o, p, q, True, 4)
    with pytest.raises(ValueError):
        thq.code_residual_rows(o, p, q[:3].contiguous(), True, 3)
    with pytest.raises(ValueError):  # rows that do not split into groups
        thq.code_residual_rows(o[:2].contiguous(), p, q[:2].contiguous(), True, 3, group=4)
    with pytest.raises(ValueError):  # contiguity
        thq.code_residual_rows(o, p.t().contiguous().t(), q, True, 3)
    for log2 in (2, 6):  # block sizes without a kernel or route
        k = 1 << (2 * log2)
        blk = T(np.zeros((6, k), np.int32))
        with pytest.raises(ValueError):
            thq.code_residual_rows(blk, blk, q, True, log2)
    with pytest.raises(NotImplementedError):
        thq.code_residual_rows(o, p, q, True, 3, bd=10)
    with pytest.raises(ValueError):  # mixed devices
        thq.code_residual_rows(o, p.to("meta"), q, True, 3)
    planes = _wave(rng, 4)
    with pytest.raises(ValueError):
        thq.code_residual_planes([planes[0], planes[1],
                                  (planes[2][0].to("meta"),) + planes[2][1:]], True)
    with pytest.raises(ValueError):  # three luma planes: 768 samples a row
        thq.code_residual_planes([planes[0], planes[0], planes[0]], True)
    with pytest.raises(ValueError):  # planes over different lane counts
        short = tuple(t[:3].contiguous() for t in planes[2][:3]) + (3,)
        thq.code_residual_planes([planes[0], planes[1], short], True)


@pytest.mark.cuda
def test_residual_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    lanes, nctu = 68, 8160  # a 1080p wave; the 1080p IDR prepass
    planes = _wave(rng, lanes)
    for intra in (True, False, T(rng.integers(0, 2, lanes).astype(bool))):
        thq.reset_launches()
        got = thq.code_residual_planes([(o.to(dev), p.to(dev), q.to(dev), lg)
                                        for o, p, q, lg in planes],
                                       intra.to(dev) if torch.is_tensor(intra) else intra)
        torch.cuda.synchronize()
        assert thq.LAUNCHES["residual"] == 1
        for (lev, rec), (o, p, q, lg) in zip(got, planes):
            want = thq.code_residual_rows_plain(o, p, q, intra, lg)
            assert torch.equal(lev.cpu(), want[0]) and torch.equal(rec.cpu(), want[1])
    for kind in KINDS:
        orig, pred = _inputs(rng, 3 * nctu, 4, kind, groups=nctu)
        q = _qp(rng, nctu, "random")
        got = thq.code_residual_rows(T(orig).to(dev), T(pred).to(dev), T(q).to(dev), True, 4,
                                     group=3)
        want = thq.code_residual_rows_plain(T(orig), T(pred), T(q), True, 4, group=3)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
