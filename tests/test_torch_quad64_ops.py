"""The port's CTB64 quadtree modules against the JAX package, op by op.

Every comparison has tolerance 0; float32 costs are compared bit for bit.
The same inputs, made from a seed with numpy, go through the JAX function
(on the CPU; its Pallas kernels are not on these paths there) and its
counterpart in kvazzup_tpu_torch:

* SATD at 64x64 (`ctu_kernels.satd_flat` at log2 6);
* the TU32 residual route (`hopper_q.code_residual_rows` /
  `code_residual_planes` at log2 5) against `_code_flat_sel` and
  `_code_flat_mode` with traced intra flags;
* the prepasses `_rd_prepass_grid` (log2 4, 5), `_rd64_prepass` and
  `_cost_prepass_grid` (mode and cost), the lambda table, the z-scan walk
  specs and substitution, the merge / AMVP lists;
* the quadtree deblocking (`spacing=8`, `chroma_every=2`, 4-sample bS);
* the trees and bS maps built on the host;
* the whole IDR64 encode at 192x128 and the P64 encode on the divergent
  256x128 input of tests/test_inter64_device.py, every output array.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvazzup_tpu.encoder import cu32 as jcu32
from kvazzup_tpu.encoder import frame_inter32 as ji32
from kvazzup_tpu.encoder import frame_intra as jfi
from kvazzup_tpu.encoder import frame_intra32 as jf32
from kvazzup_tpu.encoder import frame_intra64 as jf64
from kvazzup_tpu.encoder.frame_inter64 import (encode_frame_p64_fast as jax_p64,
                                               quad_p64_trees_from_device as jax_p64_trees)
from kvazzup_tpu.io.yuv import synthetic_frames
from kvazzup_tpu.ops import ctu_kernels as jck
from kvazzup_tpu.ops.deblock import deblock_frame as jax_deblock

from kvazzup_tpu_torch.encoder import cu32, frame_inter32, frame_intra64
from kvazzup_tpu_torch.encoder import frame_intra as tfi
from kvazzup_tpu_torch.encoder.frame_intra32 import subst_quad
from kvazzup_tpu_torch.encoder.frame_inter64 import (encode_frame_p64_fast,
                                                     quad_p64_trees_from_device)
from kvazzup_tpu_torch.ops import ctu_kernels as tck
from kvazzup_tpu_torch.ops import hopper_q
from kvazzup_tpu_torch.ops.deblock import deblock_frame

W, H = 256, 192


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy() if torch.is_tensor(got) else got)


def _noisy_luma(seed):
    y = synthetic_frames(W, H, 1, seed=seed)[0][0]
    rng = np.random.default_rng(seed)
    return np.clip(y.astype(int) + rng.integers(-40, 40, y.shape), 0, 255).astype(np.uint8)


def _jax_lam(qp, n):
    return jax.jit(lambda q: jnp.sqrt(0.57 * 2.0 ** (
        (jnp.broadcast_to(q, (n,)).astype(jnp.float32) - 12.0) / 3.0)))(jnp.int32(qp))


def test_lambda_table_matches_reference_program():
    """The reference's compiled frame set-up rounds lambda differently from
    a plain float32 evaluation at 14 QPs (QP 32 among them)."""
    z, zc = jnp.zeros((64, 96), jnp.uint8), jnp.zeros((32, 48), jnp.uint8)
    setup = jax.jit(lambda q: jfi._frame_setup(z, zc, zc, q, 24)[2])
    want = np.array([np.asarray(setup(jnp.int32(q)))[0] for q in range(52)], np.float32)
    eq(want, tfi.LAMBDA)


@pytest.mark.parametrize("group", [1, 3])
def test_satd_64x64_matches_reference(group):
    rng = np.random.default_rng(40 + group)
    a = rng.integers(0, 256, (12, 4096)).astype(np.int32)
    b = rng.integers(0, 256, (12 // group, 4096)).astype(np.int32)
    a[0], b[0] = 255, 0  # extreme difference
    want = jck.satd_flat(jnp.asarray(a).reshape(12 // group, group, 4096),
                         jnp.asarray(b)[:, None, :], 6).reshape(-1)
    eq(want, hopper_q.satd_rows(T(a), T(b), 6, group=group))
    eq(want, tck.satd_flat(T(a).reshape(12 // group, group, 4096), T(b)[:, None, :], 6)
       .reshape(-1))


@pytest.mark.parametrize("kind", ["intra", "inter", "mixed"])
def test_tu32_route_matches_code_flat(kind):
    """32x32 blocks through transform, quant, dequant, inverse, recon
    against the reference's `_code_flat_sel` (intra) and `_code_flat_mode`
    (a traced per-row intra flag)."""
    rng = np.random.default_rng({"intra": 1, "inter": 2, "mixed": 3}[kind])
    rows = 10
    orig = rng.integers(0, 256, (rows, 1024)).astype(np.int32)
    pred = rng.integers(0, 256, (rows, 1024)).astype(np.int32)
    pred[0], orig[0] = 0, 255
    qp = rng.integers(0, 52, (rows,)).astype(np.int32)
    qp[:2] = (0, 51)
    if kind == "intra":
        want = jfi._code_flat_sel(jck, jnp.asarray(orig), jnp.asarray(pred),
                                  jnp.asarray(qp)[:, None], 5, None, False)
        intra = True
    else:
        flags = np.zeros(rows, bool) if kind == "inter" else rng.integers(0, 2, rows) > 0
        want = ji32._code_flat_mode(jck, jnp.asarray(orig), jnp.asarray(pred),
                                    jnp.asarray(qp)[:, None], 5, jnp.asarray(flags)[:, None])
        intra = T(flags)
    got = hopper_q.code_residual_rows(T(orig), T(pred), T(qp), intra, 5)
    eq(want[0], got[0])
    eq(want[1], got[1])
    # the unit form: a TU32 with its two TU16 chroma blocks in one call
    planes = [(T(orig), T(pred), T(qp), 5)] + [
        (T(rng.integers(0, 256, (rows, 256)).astype(np.int32)),
         T(rng.integers(0, 256, (rows, 256)).astype(np.int32)), T(qp), 4) for _ in (0, 1)]
    got = hopper_q.code_residual_planes(planes, intra)
    eq(want[0], got[0][0])
    for o, p, q, lg in planes[1:]:
        jw = ji32._code_flat_mode(jck, jnp.asarray(o.numpy()), jnp.asarray(p.numpy()),
                                  jnp.asarray(q.numpy())[:, None], 4,
                                  jnp.asarray(np.broadcast_to(
                                      intra if isinstance(intra, bool) else intra.numpy(),
                                      (rows,)))[:, None])
        g = hopper_q.code_residual_rows(o, p, q, intra, 4)
        eq(jw[0], g[0])
        eq(jw[1], g[1])


@pytest.mark.parametrize("log2,qp,seed", [(4, 30, 7), (5, 30, 7), (4, 22, 3), (5, 37, 11)])
def test_rd_prepass_grid_matches_reference(log2, qp, seed):
    """Mode and RD cost bit for bit: the 32-term window rate sums (256 and
    1024 terms) and the FMA of the RD cost."""
    n = 1 << log2
    cw, ch = W // n, H // n
    y = _noisy_luma(seed)
    yi = jnp.asarray(y).astype(jnp.int32)
    f = jax.jit(lambda yi, oy, q, lam: jf32._rd_prepass_grid(yi, oy, q, lam, log2=log2,
                                                              cw=cw, ch=ch))
    jm, jrd = f(yi, jfi.to_blocks(yi, n), jnp.full((cw * ch,), qp, jnp.int32),
                _jax_lam(qp, cw * ch))
    yt = T(y)
    oy = tfi.to_blocks(yt.to(torch.int32), n).reshape(cw * ch, -1)
    m, rd = tfi.rd_prepass_grid(yt, oy, torch.full((cw * ch,), qp, dtype=torch.int32),
                                torch.full((cw * ch,), float(tfi.LAMBDA[qp])), log2=log2,
                                cw=cw, ch=ch)
    eq(jm, m)
    eq(jrd, rd)


@pytest.mark.parametrize("qp,seed", [(30, 7), (22, 3), (37, 11)])
def test_rd64_prepass_matches_reference(qp, seed):
    cw, ch = W // 64, H // 64
    y = _noisy_luma(seed)
    yi = jnp.asarray(y).astype(jnp.int32)
    f = jax.jit(lambda yi, oy, q, lam: jf64._rd64_prepass(yi, oy, q, lam, cw64=cw, ch64=ch))
    jm, jrd = f(yi, jfi.to_blocks(yi, 32), jnp.full((cw * ch,), qp, jnp.int32),
                _jax_lam(qp, cw * ch))
    yt = T(y)
    oy = tfi.to_blocks(yt.to(torch.int32), 32).reshape(-1, 1024)
    lam = torch.full((4 * cw * ch,), float(tfi.LAMBDA[qp]))
    sweep = tfi.mode_sweep(yt, oy, lam, 2 * cw, 2 * ch, None, 5)
    m, rd = frame_intra64.rd64_prepass(sweep, oy, torch.full((cw * ch,), qp, dtype=torch.int32),
                                       lam[:cw * ch], cw64=cw, ch64=ch)
    eq(jm, m)
    eq(jrd, rd)


@pytest.mark.parametrize("log2", [4, 5])
def test_cost_prepass_grid_matches_reference(log2):
    n = 1 << log2
    cw, ch = W // n, H // n
    y = _noisy_luma(5)
    yi = jnp.asarray(y).astype(jnp.int32)
    f = jax.jit(lambda yi, oy, lam: ji32._cost_prepass_grid(yi, oy, None, lam, log2=log2,
                                                             cw=cw, ch=ch))
    jm, jc = f(yi, jfi.to_blocks(yi, n), _jax_lam(32, cw * ch))
    yt = T(y)
    m, c = tfi.cost_prepass_grid(yt, tfi.to_blocks(yt.to(torch.int32), n).reshape(cw * ch, -1),
                                 torch.full((cw * ch,), float(tfi.LAMBDA[32])), log2=log2,
                                 cw=cw, ch=ch)
    eq(jm, m)
    eq(jc, c)


def test_walk_specs_match_reference():
    """z-scan segment specs of every unit of a CTB, and the segment
    substitution on random walks and availability."""
    for size in (64, 32):
        for x0 in range(0, size, 8):
            for y0 in range(0, size, 8):
                for n in (8, 16, 32):
                    if x0 % n == 0 and y0 % n == 0 and n <= size:
                        assert frame_intra64.seg_spec(x0, y0, n, size) == \
                            jf64._seg_spec(x0, y0, n, size)
                        assert frame_intra64.zscan(x0, y0) == jf64._z(x0, y0)
    rng = np.random.default_rng(9)
    n, lanes = 16, 64
    segs = [rng.integers(0, 256, (lanes, k)).astype(np.int32) for k in (n, n, 1, n, n)]
    flags = [rng.integers(0, 2, lanes) > 0 for _ in range(5)]
    flags[0][:4] = flags[1][:4] = flags[2][:4] = flags[3][:4] = flags[4][:4] = False
    want = jf32._subst_quad(*(jnp.asarray(s) for s in segs), *(jnp.asarray(f) for f in flags))
    eq(want, subst_quad(*(T(s) for s in segs), *(T(f) for f in flags)))


def test_merge_and_amvp_lists_match_reference():
    rng = np.random.default_rng(12)
    lanes = 200
    pos = {}
    for key in ("a1", "b1", "b0", "a0", "b2"):
        mv = rng.integers(-3, 3, (lanes, 2)).astype(np.int32)  # many equal pairs
        pos[key] = (rng.integers(0, 2, lanes) > 0, mv)
    jpos = {k: (jnp.asarray(a), jnp.asarray(m)) for k, (a, m) in pos.items()}
    tpos = {k: (T(a), T(m)) for k, (a, m) in pos.items()}
    for k in (1, 3, 5):
        for w, g in zip(ji32._merge_list_cells(jpos, k), frame_inter32.merge_list_cells(tpos, k)):
            eq(w, g)
    want = ji32._amvp_cells([jpos["a0"], jpos["a1"]], [jpos["b0"], jpos["b1"], jpos["b2"]])
    got = frame_inter32.amvp_cells([tpos["a0"], tpos["a1"]],
                                   [tpos["b0"], tpos["b1"], tpos["b2"]])
    for w, g in zip(want, got):
        eq(w, g)


@pytest.mark.parametrize("p_frame", [False, True])
def test_quad_deblock_matches_reference(p_frame):
    """spacing 8, chroma on every second edge; P pictures with bS per
    4-sample segment (0 / 1 / 2), IDR with bS 0 / 2 per 8 samples."""
    rng = np.random.default_rng(30 + p_frame)

    def plane(h, w, step):  # small steps between 8x8 blocks: the filters switch on
        base = np.kron(rng.integers(-step, step + 1, (h // 8, w // 8)), np.ones((8, 8), int))
        return np.clip(120 + base + rng.integers(0, 3, (h, w)), 0, 255).astype(np.uint8)

    y, u, v = plane(128, 192, 12), plane(64, 96, 6), plane(64, 96, 6)
    rep = 4 if p_frame else 8
    vals = (0, 1, 2) if p_frame else (0, 2)
    bv = rng.choice(vals, (192 // 8 - 1, 128 // rep)).astype(np.int32)
    bh = rng.choice(vals, (128 // 8 - 1, 192 // rep)).astype(np.int32)
    kw = dict(bs_rep=4) if p_frame else {}
    for qp in (22, 37):
        want = jax_deblock(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), qp, spacing=8,
                           bs_v=jnp.asarray(bv), bs_h=jnp.asarray(bh), chroma_every=2, **kw)
        got = deblock_frame(T(y), T(u), T(v), qp, spacing=8, bs_v=T(bv), bs_h=T(bh),
                            chroma_every=2, **kw)
        for w, g in zip(want, got):
            eq(w, g)
    with pytest.raises(NotImplementedError):
        deblock_frame(T(y), T(u), T(v), 30, spacing=8, qp_map=T(np.zeros((16, 24), np.int32)))


def _tree_equal(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def idr64():
    """The JAX and port IDR64 encodes of one 192x128 frame at QP 30."""
    f = synthetic_frames(192, 128, 1, seed=5)[0]
    jo = jf64.encode_frame_intra64_fast(*(jnp.asarray(p) for p in f), 30, width=192,
                                        height=128)
    to = frame_intra64.encode_frame_intra64_fast(*(T(p) for p in f), 30, width=192,
                                                 height=128)
    return {k: np.asarray(v) for k, v in jo.items()}, to


def test_idr64_encode_matches_reference(idr64):
    jo, to = idr64
    assert jo.keys() == to.keys()
    for k in jo:
        assert jo[k].dtype == to[k].numpy().dtype, k
        eq(jo[k], to[k])
    assert 0 < jo["split64"].sum() < jo["split64"].size  # both CU64 leaves and splits


def test_idr64_trees_and_bs_maps_match_reference(idr64):
    jo, to = idr64
    jt = jf64.quad_trees_from_device64(jo, 192, 128)
    tt = frame_intra64.quad_trees_from_device64(to, 192, 128)
    _tree_equal(jt, tt)
    for w, g in zip(jcu32.quad_bs_maps(jt, 192, 128, 6), cu32.quad_bs_maps(tt, 192, 128, 6)):
        eq(w, g)


def _divergent_pair():
    """test_p64_exercises_all_levels' input: per-band divergent motion on
    the left half (forces split64), one shift on the right (CU64 leaves)."""
    w, h = 256, 128
    f0 = synthetic_frames(w, h, 1, seed=9)[0]
    f1 = []
    for p in f0:
        q = p.copy()
        half = q.shape[1] // 2
        band = 32 if q.shape[0] >= h // 2 else 16
        for bi in range(q.shape[0] // band):
            q[bi * band:(bi + 1) * band, :half] = np.roll(
                q[bi * band:(bi + 1) * band, :half], (bi % 5 - 2) * 3, axis=1)
        q[:, half:] = np.roll(q[:, half:], 2, axis=1)
        f1.append(q)
    return f0, tuple(f1)


@pytest.fixture(scope="module")
def p64():
    f0, f1 = _divergent_pair()
    jo = jax_p64(*(jnp.asarray(p) for p in f1), *(jnp.asarray(p) for p in f0), 30,
                 width=256, height=128, merge_cand=3)
    to = encode_frame_p64_fast(*(T(p) for p in f1), *(T(p) for p in f0), 30, width=256,
                               height=128, merge_cand=3)
    return {k: np.asarray(v) for k, v in jo.items()}, to


def test_p64_all_levels_matches_reference(p64):
    jo, to = p64
    assert jo.keys() == to.keys()
    for k in jo:
        assert jo[k].dtype == to[k].numpy().dtype, k
        eq(jo[k], to[k])
    s64 = jo["split64"]
    assert 0 < s64.sum() < s64.size
    assert (jo["ct64"][s64 == 0] != 0).any()


def test_p64_trees_and_bs_maps_match_reference(p64):
    jo, to = p64
    jt = jax_p64_trees(jo, 256, 128)
    tt = quad_p64_trees_from_device(to, 256, 128)
    _tree_equal(jt, tt)
    jc = ji32.quad_p_cell_maps(jt, 256, 128, ctb=64)
    tc = frame_inter32.quad_p_cell_maps(tt, 256, 128, ctb=64)
    for w, g in zip(jc, tc):
        eq(w, g)
    for w, g in zip(ji32.quad_p_bs_maps(jt, *jc, 256, 128, ctb=64),
                    frame_inter32.quad_p_bs_maps(tt, *tc, 256, 128, ctb=64)):
        eq(w, g)


def test_unported_p64_options_raise():
    z = torch.zeros((128, 256), dtype=torch.uint8)
    zc = torch.zeros((64, 128), dtype=torch.uint8)
    for kw in (dict(xtile=(True, False)), dict(xtile=(False, True))):
        with pytest.raises(NotImplementedError):
            encode_frame_p64_fast(z, zc, zc, z, zc, zc, 30, width=256, height=128, **kw)
    tu32 = torch.zeros((4, 1024), dtype=torch.int32)  # the TU32 route at Main10
    with pytest.raises(NotImplementedError):
        hopper_q.code_residual_rows(tu32, tu32, torch.full((4,), 30, dtype=torch.int32), True, 5,
                                    bd=10)
    with pytest.raises(NotImplementedError):
        frame_intra64.encode_frame_intra64_fast(z, zc, zc, 30, width=256, height=128,
                                                bit_depth=10)
