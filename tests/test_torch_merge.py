"""The port's P-wave merge search (kvazzup_tpu_torch/ops/merge.py) against
the JAX reference's merge block, element for element.

The reference is a `jax.jit` of the loop in
kvazzup_tpu/encoder/frame_inter.py (every candidate's luma MC, its SATD
against the original, `SATD + lambda * (2 + merge_idx bits)`, argmin and
the gathers), so its compiled CPU program contracts the cost into one
FMA, as in the encoder.  Inputs are numpy arrays from a seed: 1..5
candidates, all 16 quarter-pel phase pairs, MVs whose filter support
leaves the 55x55 window (zero fill), equal candidates and tied costs
(first index wins), and windows taken from sheared strips at a clamped
start (the last waves).  The cost is compared bit for bit.  The CUDA
kernel itself is held against `merge_search_plain` by
tests/test_torch_kernels.py (on a GPU) and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazzup_tpu.ops import ctu_kernels as jck
from kvazzup_tpu.ops import mc as jmc

from kvazzup_tpu_torch.ops import mc as tmc
from kvazzup_tpu_torch.ops import merge as tmerge

N, SR, WIN, LANES = 16, 16, 55, 16


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@jax.jit
def _reference(winy, cands, oyw, lamf):
    """The reference's merge block (frame_inter.py:472-490, no tiles)."""
    K, lanes = cands.shape[:2]
    preds_m, costs_m = [], []
    for k in range(K):
        idx_bits = float(min(k + 1, K - 1)) if K > 1 else 0.0
        pk = jmc.mc_luma_window_batch(winy, cands[k], N, SR)
        cost_k = jck.satd_flat(pk.reshape(lanes, -1), oyw, 4).astype(
            jnp.float32) + lamf * (2.0 + idx_bits)
        preds_m.append(pk.reshape(lanes, -1))
        costs_m.append(cost_k)
    costs_s = jnp.stack(costs_m)
    merge_idx = jnp.argmin(costs_s, axis=0).astype(jnp.int32)
    cost_merge = jnp.take_along_axis(costs_s, merge_idx[None], 0)[0]
    merge_mv = jnp.take_along_axis(cands, merge_idx[None, :, None], 0)[0]
    pm_flat = jnp.take_along_axis(jnp.stack(preds_m), merge_idx[None, :, None], 0)[0]
    return merge_idx, cost_merge, merge_mv, pm_flat


def _assert_same(ref, got):
    idx, cost, mv, pred = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(idx, got[0].numpy())
    assert got[1].dtype == torch.float32
    np.testing.assert_array_equal(cost.view(np.int32), got[1].numpy().view(np.int32))
    np.testing.assert_array_equal(mv, got[2].numpy())
    np.testing.assert_array_equal(pred, got[3].numpy())
    assert got[0].dtype == got[2].dtype == got[3].dtype == torch.int32


def _mvs(rng, k_cands):
    """(K, LANES, 2) quarter-pel MVs: candidate 0 takes all 16 phase pairs
    (one per lane) at integer parts up to +-17 px, so some reach outside
    the window; the others are random in +-20 px."""
    mvs = rng.integers(-80, 81, (k_cands, LANES, 2)).astype(np.int32)
    phase = np.arange(LANES)
    ints = rng.integers(-17, 17, (LANES, 2))
    # -17 px at a non-zero phase (-16 3/4 .. -16 1/4 px): the filter reads
    # column or row -1 of the window
    ints[1], ints[5], ints[6] = (-17, 5), (3, -17), (-17, -17)
    mvs[0, :, 0] = 4 * ints[:, 0] + phase % 4
    mvs[0, :, 1] = 4 * ints[:, 1] + phase // 4
    return mvs


def _inputs(seed, k_cands, flat=False):
    rng = np.random.default_rng(seed)
    if flat:
        win = np.full((LANES, WIN, WIN), 77, np.uint8)
        orig = np.full((LANES, N * N), 70, np.int32)
    else:
        win = rng.integers(0, 256, (LANES, WIN, WIN)).astype(np.uint8)
        orig = rng.integers(0, 256, (LANES, N * N)).astype(np.int32)
    lam = (rng.random(LANES) * 200).astype(np.float32)
    return win, _mvs(rng, k_cands), orig, lam


def _plain(win, mvs, orig, lam):
    return tmerge.merge_search_plain(T(win), [T(m) for m in mvs], T(orig), T(lam), N, SR)


@pytest.mark.parametrize("k_cands", [1, 2, 3, 4, 5])
def test_plain_matches_reference(k_cands):
    win, mvs, orig, lam = _inputs(k_cands, k_cands)
    got = _plain(win, mvs, orig, lam)
    _assert_same(_reference(win, mvs, orig, lam), got)
    if k_cands > 1:
        assert len(set(got[0].tolist())) > 1  # the choice varies over lanes


@pytest.mark.parametrize("k_cands", [2, 3, 5])
def test_ties_keep_the_first_candidate(k_cands):
    """Ties: equal candidates (half the lanes at lambda 0); the last two
    candidates equal and exact (SATD 0, and equal index bits); flat content
    at lambda 0, where every candidate costs the same."""
    win, mvs, orig, lam = _inputs(10 + k_cands, k_cands)
    same = mvs.copy()
    same[1:] = same[0]
    lam0 = lam.copy()
    lam0[::2] = 0.0
    got = _plain(win, same, orig, lam0)
    _assert_same(_reference(win, same, orig, lam0), got)
    assert not got[0].any()

    mvs[-2:] = mvs[-1]
    exact = tmc.mc_luma_window_batch(T(win), T(mvs[-1]), N, SR).reshape(LANES, -1).numpy()
    got = _plain(win, mvs, exact, lam)
    _assert_same(_reference(win, mvs, exact, lam), got)
    assert (got[0] == k_cands - 2).all() and not got[3].sub(T(exact)).any()

    fwin, fmvs, forig, flam = _inputs(20 + k_cands, k_cands, flat=True)
    fmvs = np.clip(fmvs, -60, 60)  # support inside the window: flat predictions
    flam[:] = 0.0
    got = _plain(fwin, fmvs, forig, flam)
    _assert_same(_reference(fwin, fmvs, forig, flam), got)
    assert not got[0].any()


def test_wave_object_matches_reference_at_clamped_starts():
    """MergeSearch on CPU tensors: each wave's windows come from the strips
    as the reference's dynamic slice takes them (its start clamped at the
    last waves); results land in the frame's buffers, no launch."""
    rng = np.random.default_rng(5)
    k_cands, nw, total = 3, 6, WIN + 2 * N + 5
    strips = rng.integers(0, 256, (LANES, WIN, total)).astype(np.uint8)
    oy_w = rng.integers(0, 256, (nw, LANES, N * N)).astype(np.int32)
    lam_w = (rng.random((nw, LANES)) * 100).astype(np.float32)
    tmerge.reset_launches()
    ms = tmerge.MergeSearch(T(strips), T(oy_w), T(lam_w), k_cands)
    for d in range(nw):  # starts 0, 16, 32, then clamped to 37
        mvs = _mvs(rng, k_cands)
        winy = jmc.strip_window_slice(jnp.asarray(strips), d, N, SR)
        got = ms.wave(d, [T(m) for m in mvs])
        _assert_same(_reference(winy, mvs, oy_w[d], lam_w[d]), got)
        np.testing.assert_array_equal(ms.merge_idx[d].numpy(), got[0].numpy())
        np.testing.assert_array_equal(ms.pred[d].numpy(), got[3].numpy())
    assert tmerge.LAUNCHES == {"merge": 0}


def test_merge_search_rejects_what_the_kernel_does_not_take():
    z = torch.zeros
    strips = z((4, WIN, 80), dtype=torch.uint8)
    oy_w, lam_w = z((3, 4, 256), dtype=torch.int32), z((3, 4), dtype=torch.float32)
    with pytest.raises(ValueError):
        tmerge.MergeSearch(strips, oy_w, lam_w, 6)
    with pytest.raises(ValueError):
        tmerge.MergeSearch(strips, oy_w, lam_w, 1, n=8)
    with pytest.raises(ValueError):
        tmerge.MergeSearch(strips[:3].contiguous(), oy_w, lam_w, 1)
    with pytest.raises(TypeError):
        tmerge.MergeSearch(strips, oy_w, lam_w.double(), 1)
    ms = tmerge.MergeSearch(strips, oy_w, lam_w, 2)
    with pytest.raises(ValueError):
        ms.wave(0, [z((4, 2), dtype=torch.int32)])
