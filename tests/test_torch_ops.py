"""kvazzup_tpu_torch ops against the JAX package, element for element.

The same numpy inputs (seeded) go through the JAX function and its port;
every comparison is exact (tolerance 0).  Pallas kernels of the reference
run in interpret mode, as tests/test_pallas_q.py runs them.  On the CPU the
port's kernel wrappers take their plain PyTorch versions; the CUDA kernels
themselves are checked by tests/test_torch_kernels.py (on a GPU) and by
chip_smoke.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kvazzup_tpu.ops import ctu_kernels as jck
from kvazzup_tpu.ops import deblock as jdb
from kvazzup_tpu.ops import intra as jintra
from kvazzup_tpu.ops import mc as jmc
from kvazzup_tpu.ops import me as jme
from kvazzup_tpu.ops import pallas_q as jpq
from kvazzup_tpu.ops import quant as jquant
from kvazzup_tpu.ops import satd as jsatd
from kvazzup_tpu.ops import transforms as jtr

from kvazzup_tpu_torch.ops import costs as tcost
from kvazzup_tpu_torch.ops import ctu_kernels as tck
from kvazzup_tpu_torch.ops import deblock as tdb
from kvazzup_tpu_torch.ops import hopper_q as thq
from kvazzup_tpu_torch.ops import intra as tintra
from kvazzup_tpu_torch.ops import mc as tmc
from kvazzup_tpu_torch.ops import me as tme
from kvazzup_tpu_torch.ops import quant as tquant
from kvazzup_tpu_torch.ops import satd as tsatd
from kvazzup_tpu_torch.ops import transforms as ttr


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.cpu().numpy())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KVZ_TPU_PALLAS_INTERPRET", "1")


# ----------------------------------------------------------- table builders


@pytest.mark.parametrize("log2,dst", [(2, False), (2, True), (3, False), (4, False), (5, False)])
def test_table_builders_transform(log2, dst):
    np.testing.assert_array_equal(jtr.transform_matrices(log2, dst),
                                  ttr.transform_matrices(log2, dst))
    for inv in (False, True):
        for a, b in zip(jck._kron_stages(log2, dst, inv), tck._kron_stages(log2, dst, inv)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_table_builders_satd(log2):
    """The port's butterflies need no weights: they give the coefficient
    magnitudes of the reference's (N^2, N^2) Hadamard weight map."""
    n2 = 1 << (2 * log2)
    bs = min(8, 1 << log2)
    np.testing.assert_array_equal(jsatd._hadamard(bs), tsatd._hadamard(bs))
    rng = np.random.default_rng(log2)
    a = rng.integers(0, 256, (12, n2)).astype(np.int32)
    b = rng.integers(0, 256, (12, n2)).astype(np.int32)
    coef = np.abs((a - b).astype(np.int64) @ jck._satd_weights(log2).astype(np.int64))
    s = coef.reshape(12, -1, bs * bs).sum(-1)
    want = (((s + 2) >> 2) if bs == 8 else ((s + 1) >> 1)).sum(-1)
    np.testing.assert_array_equal(want, thq.satd_rows_plain(T(a), T(b), log2).numpy())


@pytest.mark.parametrize("log2,is_luma", [(2, True), (3, False), (3, True), (4, True), (5, True)])
def test_table_builders_intra(log2, is_luma):
    for a, b in zip(jintra._angular_tables(log2, is_luma), tintra._angular_tables(log2, is_luma)):
        np.testing.assert_array_equal(a, b)
    jw, tw = jck._intra_weights(log2, is_luma), tck._intra_weights(log2, is_luma)
    np.testing.assert_array_equal(jw[0], tw[0])
    np.testing.assert_array_equal(jw[1], tw[1])
    assert jw[2] == tw[2]


# ------------------------------------------------ float32 cost arithmetic


def test_bits_table_matches_reference_log2():
    v = np.arange(1, tcost.TABLE_MAX + 1, dtype=np.int32)
    want = jax.jit(lambda x: 2.0 * jnp.log2(x.astype(jnp.float32)) + 1.0)(jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(want), tcost._bits_table_np()[1:])
    got = tcost.bits_of(T(v - 1))
    eq(want, got)


def test_bits_row_sum_matches_reference():
    rng = np.random.default_rng(0)
    lev = (rng.integers(-200, 200, (64, 3, 256)) * (rng.random((64, 3, 256)) < 0.3)).astype(np.int32)
    want = jax.jit(lambda l: jnp.sum(jnp.where(
        l != 0, 2.0 * jnp.log2(jnp.abs(l).astype(jnp.float32) + 1.0) + 1.0, 0.0), axis=-1))(lev)
    eq(want, tcost.bits_row_sum(T(lev)))


def test_fma_matches_fused_reference():
    rng = np.random.default_rng(1)
    a, b, c = (rng.random(4096).astype(np.float32) * 300 for _ in range(3))
    eq(jax.jit(lambda a, b, c: a + b * c)(a, b, c), tcost.fma(T(b), T(c), T(a)))


def test_fma_single_rounding():
    """b * c + a whose float64 sum lands on a float32 rounding midpoint:
    1 + 2^-23 + 2^-24 - 2^-70 lies below the midpoint, so the single-rounded
    result is 1 + 2^-23, while rounding through float64 gives 1 + 2^-22."""
    a = np.array([1 + 2.0 ** -23], np.float32)
    b = np.array([2.0 ** -24 * (1 + 2.0 ** -23)], np.float32)
    c = np.array([1 - 2.0 ** -23], np.float32)
    want = np.array([1 + 2.0 ** -23], np.float32)
    assert (b.astype(np.float64) * c + a).astype(np.float32)[0] != want[0]
    eq(want, tcost.fma(T(b), T(c), T(a)))
    eq(jax.jit(lambda a, b, c: a + b * c)(a, b, c), tcost.fma(T(b), T(c), T(a)))


# -------------------------------------------------------------- transforms


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_transforms_flat(log2):
    n2 = 1 << (2 * log2)
    rng = np.random.default_rng(log2)
    resid = rng.integers(-255, 256, (2, 9, n2)).astype(np.int32)
    eq(jck.fwd_transform_flat(jnp.asarray(resid), log2), tck.fwd_transform_flat(T(resid), log2))
    coef = rng.integers(-32768, 32768, (2, 9, n2)).astype(np.int32)
    eq(jck.inv_transform_flat(jnp.asarray(coef), log2), tck.inv_transform_flat(T(coef), log2))


# ---------------------------------------------------------- quant/dequant


@pytest.mark.parametrize("log2", [3, 4])
@pytest.mark.parametrize("mode", ["scalar", "per_row", "per_lane_intra"])
def test_quantize_dequantize(log2, mode):
    rng = np.random.default_rng(11 + log2)
    b, k = 68, 1 << (2 * log2)
    coef = rng.integers(-30000, 30000, (b, 3, k)).astype(np.int32)
    qp = 27 if mode == "scalar" else rng.integers(0, 52, (b,)).astype(np.int32)
    intra = True if mode != "per_lane_intra" else rng.integers(0, 2, (b,)).astype(bool)
    jq = jnp.asarray(qp) if mode != "scalar" else qp
    ji = jnp.asarray(intra) if mode == "per_lane_intra" else intra
    tq = T(qp) if mode != "scalar" else qp
    ti = T(intra) if mode == "per_lane_intra" else intra
    want = jquant.quantize(jnp.asarray(coef), jq, log2, ji)
    got = tquant.quantize(T(coef), tq, log2, ti)
    eq(want, got)
    lev = rng.integers(-32768, 32768, (b, 3, k)).astype(np.int32)
    eq(jquant.dequantize(jnp.asarray(lev), jq, log2), tquant.dequantize(T(lev), tq, log2))


@pytest.mark.parametrize("log2", [4, 5])
def test_quant_rows_vs_pallas_interpret(log2, interpret):
    rng = np.random.default_rng(3)
    b, k = 300, 1 << (2 * log2)
    coef = rng.integers(-30000, 30000, (b, k)).astype(np.int32)
    qp = rng.integers(0, 52, (b,)).astype(np.int32)
    dz = np.where(rng.integers(0, 2, (b,)) > 0, 171, 85).astype(np.int32)
    want = jpq.quantize_2d(jnp.asarray(coef), jnp.asarray(qp[:, None]),
                           jnp.asarray(dz[:, None]), log2)
    eq(want, thq.quantize_rows(T(coef), T(qp), T(dz), log2))
    lev = rng.integers(-32768, 32767, (b, k)).astype(np.int32)
    want = jpq.dequantize_2d(jnp.asarray(lev), jnp.asarray(qp[:, None]), log2)
    eq(want, thq.dequantize_rows(T(lev), T(qp), log2))


# --------------------------------------------------------------------- SATD


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_satd_flat_2d(log2):
    n2 = 1 << (2 * log2)
    rng = np.random.default_rng(7 + log2)
    a = rng.integers(0, 256, (40, n2)).astype(np.int32)
    b = rng.integers(0, 256, (40, n2)).astype(np.int32)
    eq(jck.satd_flat(jnp.asarray(a), jnp.asarray(b), log2), tck.satd_flat(T(a), T(b), log2))


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_satd_flat_broadcast_3d(log2):
    n2 = 1 << (2 * log2)
    rng = np.random.default_rng(17 + log2)
    preds = rng.integers(0, 256, (6, 35, n2)).astype(np.int32)
    orig = rng.integers(0, 256, (6, n2)).astype(np.int32)
    want = jck.satd_flat(jnp.asarray(preds), jnp.asarray(orig)[:, None, :], log2)
    eq(want, tck.satd_flat(T(preds), T(orig)[:, None, :], log2))


def test_satd_rows_vs_pallas_interpret(interpret):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (300, 256)).astype(np.int32)
    b = rng.integers(0, 256, (300, 256)).astype(np.int32)
    want = jpq.satd_2d(jnp.asarray(a), jnp.asarray(b), jnp.asarray(jck._satd_weights(4)), 4)
    eq(want, thq.satd_rows(T(a), T(b), 4))


def test_satd_blocks():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (5, 16, 16)).astype(np.int32)
    b = rng.integers(0, 256, (5, 16, 16)).astype(np.int32)
    eq(jsatd.satd_blocks(jnp.asarray(a), jnp.asarray(b)), tsatd.satd_blocks(T(a), T(b)))


# -------------------------------------------------------------------- intra


@pytest.mark.parametrize("n", [8, 16])
def test_substitute_refs_ctb(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 256, (64, 4 * n + 1)).astype(np.int32)
    fl, fa, ftr = (rng.integers(0, 2, (64,)).astype(bool) for _ in range(3))
    want = jintra.substitute_refs_ctb(jnp.asarray(a), jnp.asarray(fl), jnp.asarray(fa),
                                      jnp.asarray(ftr), n)
    eq(want, tintra.substitute_refs_ctb(T(a), T(fl), T(fa), T(ftr), n))
    eq(jintra.filter_refs(jnp.asarray(a)), tintra.filter_refs(T(a)))


@pytest.mark.parametrize("log2,is_luma", [(3, False), (3, True), (4, True), (5, True)])
def test_predict_all_modes_flat(log2, is_luma):
    n = 1 << log2
    rng = np.random.default_rng(log2 * 10 + is_luma)
    a = rng.integers(0, 256, (12, 4 * n + 1)).astype(np.int32)
    eq(jck.predict_all_modes_flat(jnp.asarray(a), log2, is_luma),
       tck.predict_all_modes_flat(T(a), log2, is_luma))


@pytest.mark.parametrize("log2,is_luma", [(3, False), (4, True)])
def test_predict_modes_subset_flat(log2, is_luma):
    modes = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34)
    n = 1 << log2
    rng = np.random.default_rng(99 + log2)
    a = rng.integers(0, 256, (12, 4 * n + 1)).astype(np.int32)
    eq(jck.predict_modes_subset_flat(jnp.asarray(a), log2, is_luma, modes),
       tck.predict_modes_subset_flat(T(a), log2, is_luma, modes))


# ----------------------------------------------------------- motion search


def _me_frames(w, h, seed):
    from kvazzup_tpu.io.yuv import synthetic_frames

    fr = synthetic_frames(w, h, 3, seed=seed)
    return fr[2][0], fr[0][0]


@pytest.mark.parametrize("lam_x1k", [0, 933, 2900, 9137, 47000])
def test_motion_search(lam_x1k):
    w, h = 64, 48
    orig, ref = _me_frames(w, h, 12)
    ref = np.roll(ref, (3, -5), (0, 1))
    jmv, jcost = jme.motion_search(jnp.asarray(orig), jnp.asarray(ref), jnp.int32(lam_x1k),
                                   block=16, search_range=16, width=w, height=h)
    tmv, tcost_ = tme.motion_search(T(orig), T(ref), lam_x1k, block=16, search_range=16,
                                    width=w, height=h)
    eq(jmv, tmv)
    eq(jcost, tcost_)


# ------------------------------------------------------ motion compensation


def _windows(seed, lanes=20, win=55):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (lanes, win, win)).astype(np.uint8)


def test_window_select_batch():
    wins = _windows(1, win=28)
    rng = np.random.default_rng(2)
    oy = rng.integers(-3, 20, (20,)).astype(np.int32)
    ox = rng.integers(-3, 20, (20,)).astype(np.int32)
    for cl in (False, True):
        want = jmc.window_select_batch(jnp.asarray(wins), jnp.asarray(oy), jnp.asarray(ox),
                                       12, 11, channels_last=cl)
        eq(want, tmc.window_select_batch(T(wins), T(oy), T(ox), 12, 11, channels_last=cl))


@pytest.mark.parametrize("chroma", [False, True])
def test_mc_window_batch(chroma):
    rng = np.random.default_rng(3 + chroma)
    size, sr = (8, 16) if chroma else (16, 16)
    win = size + (sr // 2) * 2 + 3 if chroma else size + 2 * sr + 7
    wins = _windows(5 + chroma, win=win)
    mvs = rng.integers(-4 * sr, 4 * sr + 1, (20, 2)).astype(np.int32)
    if chroma:
        fns = [(jmc.mc_chroma_window_batch, tmc.mc_chroma_window_batch),
               (jmc.mc_chroma_window_batch_14bit, tmc.mc_chroma_window_batch_14bit)]
    else:
        fns = [(jmc.mc_luma_window_batch, tmc.mc_luma_window_batch),
               (jmc.mc_luma_window_batch_14bit, tmc.mc_luma_window_batch_14bit)]
    for jf, tf in fns:
        eq(jf(jnp.asarray(wins), jnp.asarray(mvs), size, sr), tf(T(wins), T(mvs), size, sr))


@pytest.mark.parametrize("chroma", [False, True])
def test_mc_windows_and_strips(chroma):
    from kvazzup_tpu.encoder.wavefront import schedule_r

    rng = np.random.default_rng(8)
    n = 8 if chroma else 16
    pad = 12 if chroma else 24
    cw, ch = 5, 3
    plane = rng.integers(0, 256, (ch * n, cw * n)).astype(np.uint8)
    jpad = jnp.pad(jnp.asarray(plane), pad, mode="edge")
    tpad = tmc.edge_pad(T(plane), pad)
    eq(jpad, tpad)
    eq(jmc.extract_mc_neighborhoods(jpad, n, 16, cw, ch, pad, chroma=chroma),
       tmc.extract_mc_neighborhoods(tpad, n, 16, cw, ch, pad, chroma=chroma))
    js = jmc.sheared_ref_strips(jpad, n, 16, ch, pad, chroma=chroma)
    ts = tmc.sheared_ref_strips(tpad, n, 16, ch, pad, chroma=chroma)
    eq(js, ts)
    for d in range(schedule_r(cw, ch)["n_waves"]):
        eq(jmc.strip_window_slice(js, d, n, 16, chroma=chroma),
           tmc.strip_window_slice(ts, d, n, 16, chroma=chroma))
    p14 = rng.integers(-2000, 18000, (4, 16, 16)).astype(np.int32)
    eq(jmc.uni_round(jnp.asarray(p14)), tmc.uni_round(T(p14)))


# ----------------------------------------------------------------- deblock


def test_compute_bs():
    rng = np.random.default_rng(4)
    cw, ch = 6, 4
    ctype = rng.integers(0, 4, (cw * ch,)).astype(np.int32)
    cbf = rng.integers(0, 2, (cw * ch,)).astype(bool)
    mvs = rng.integers(-8, 9, (cw * ch, 2)).astype(np.int32)
    for jb, tb in zip(jdb.compute_bs(jnp.asarray(ctype), jnp.asarray(cbf), jnp.asarray(mvs), cw, ch),
                      tdb.compute_bs(T(ctype), T(cbf), T(mvs), cw, ch)):
        eq(jb, tb)


@pytest.mark.parametrize("qp,with_bs", [(22, False), (32, True), (45, True)])
def test_deblock_frame(qp, with_bs):
    from kvazzup_tpu.io.yuv import synthetic_frames

    w, h = 96, 64
    y, u, v = synthetic_frames(w, h, 1, seed=qp)[0]
    rng = np.random.default_rng(qp)
    # blocky content so that every filter branch fires
    y = np.clip(y.astype(np.int32) + rng.integers(-20, 21, (h // 16, w // 16)).repeat(16, 0).repeat(16, 1), 0, 255).astype(np.uint8)
    kw_j, kw_t = {}, {}
    if with_bs:
        bs_v = rng.integers(0, 3, (w // 16 - 1, h // 16)).astype(np.int32)
        bs_h = rng.integers(0, 3, (h // 16 - 1, w // 16)).astype(np.int32)
        kw_j = dict(bs_v=jnp.asarray(bs_v), bs_h=jnp.asarray(bs_h))
        kw_t = dict(bs_v=T(bs_v), bs_h=T(bs_h))
    want = jdb.deblock_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), qp, spacing=16, **kw_j)
    got = tdb.deblock_frame(T(y), T(u), T(v), qp, spacing=16, **kw_t)
    for a, b in zip(want, got):
        eq(a, b)


@pytest.mark.parametrize("case", ["me_tiles", "deblock_main10", "residual_main10",
                                  "deblock_qp_map"])
def test_unported_options_raise(case):
    from kvazzup_tpu_torch.ops.hopper_q import code_residual_rows

    y = torch.zeros((32, 32), dtype=torch.uint8)
    c = torch.zeros((16, 16), dtype=torch.uint8)
    rows = torch.zeros((4, 256), dtype=torch.int32)
    qp = torch.full((4,), 30, dtype=torch.int32)
    calls = {
        "me_tiles": lambda: tme.motion_search(y, y, 0, width=32, height=32, xtile=(True, False)),
        "deblock_main10": lambda: tdb.deblock_frame(y, c, c, 30, bd=10),
        "residual_main10": lambda: code_residual_rows(rows, rows, qp, True, 4, bd=10),
        "deblock_qp_map": lambda: tdb.deblock_frame(y, c, c, 30,
                                                    qp_map=torch.full((2, 2), 30)),
    }
    with pytest.raises(NotImplementedError):
        calls[case]()
