"""The port's CTB64 B-engine ops against the JAX package, tolerance 0.

The same inputs, made from a seed with numpy, go through the JAX function
(jitted on the CPU) and its counterpart in kvazzup_tpu_torch:

* `frame_b.scale_mv` over every clipped POC distance pair tb, td in
  [-128, 127], at extreme and negative MVs;
* `ops.mc.bi_round` on random 14-bit pairs, overflowing and clipping ones
  included;
* the B merge list (`merge_list_cells_b`, K = 1..5) and per-list AMVP
  (`amvp_cells_b`) on seeded random neighbour sets (availability, pred
  flags, MVs) that hold combined candidates, full lists and neighbours
  that use only the other list;
* the L0 / L1 / BI / merge / intra arbitration (`arbitrate_b`) at 17
  lanes with 5 merge candidates, at 16x16, 32x32 and 64x64;
* the float32 cost rules: each `a + b * c` the reference writes in the B
  engine is one fused multiply-add in its compiled program, and a plain
  multiply-then-add differs from it.  The arbitration is also run on
  lanes whose lambda steps ulp by ulp across a tie of two of its costs:
  the port's decisions equal the reference's, and without the fused
  multiply-adds they do not;
* the arbitration's tie rules on exact ties: the first index wins an
  argmin, merge wins a tie with the explicit costs, intra loses one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvazzup_tpu.encoder import frame_b64 as jb64
from kvazzup_tpu.encoder.frame_b import scale_mv as jax_scale_mv
from kvazzup_tpu.ops import ctu_kernels as jck
from kvazzup_tpu.ops.mc import bi_round as jax_bi_round

from kvazzup_tpu_torch.encoder import frame_b64
from kvazzup_tpu_torch.encoder.frame_b import scale_mv
from kvazzup_tpu_torch.encoder.frame_intra import LAMBDA
from kvazzup_tpu_torch.ops import costs
from kvazzup_tpu_torch.ops.mc import bi_round

SR = 16
MVS = np.array([-32768, -32767, -16385, -4097, -1000, -129, -128, -65, -64, -63, -2, -1, 0, 1,
                2, 63, 64, 65, 127, 128, 1000, 4095, 16384, 32767], np.int32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy() if torch.is_tensor(got) else got,
                                  err_msg=msg)


def test_scale_mv_exhaustive():
    """Every (tb, td) in [-128, 127]^2 at MVs up to the int16 extremes, both
    signs: 8.5.3.2.9's division, arithmetic shift of negative values and
    sign-magnitude rounding."""
    tb, td = np.meshgrid(np.arange(-128, 128, dtype=np.int32),
                         np.arange(-128, 128, dtype=np.int32), indexing="ij")
    want = np.asarray(jax.jit(jax_scale_mv)(jnp.asarray(MVS[None, :]),
                                            jnp.asarray(tb.reshape(-1, 1)),
                                            jnp.asarray(td.reshape(-1, 1))))
    mv = T(MVS)
    got = np.stack([scale_mv(mv, b, d).numpy() for b, d in zip(tb.reshape(-1), td.reshape(-1))])
    eq(want, got)
    assert (want < 0).any() and (np.abs(want) == 32768).any()  # clipping reached


def test_bi_round_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.integers(-20000, 40000, (4096,)).astype(np.int32)
    b = rng.integers(-20000, 40000, (4096,)).astype(np.int32)
    a[:4] = (-10240, 26560, -8192, 16383)  # the 14-bit range's ends
    b[:4] = (-10240, 26560, 8191, 16383)
    want = np.asarray(jax_bi_round(jnp.asarray(a), jnp.asarray(b)))
    eq(want, bi_round(T(a), T(b)))
    assert (want == 0).any() and (want == 255).any() and ((want > 0) & (want < 255)).any()


def _nbr_sets(rng, lanes: int):
    """Five random neighbours (avail, pf, mv): pred flags of every kind, a
    used list's MV from a small alphabet (so equal motion recurs), an
    unused list's zero, available only when inter."""
    out = []
    for _ in range(5):
        pf = rng.integers(0, 2, (lanes, 2)).astype(np.int32)
        mv = rng.integers(-2, 3, (lanes, 2, 2)).astype(np.int32) * 4 * pf[:, :, None]
        avail = (rng.random(lanes) < 0.8) & (pf.any(1))
        out.append((avail, pf, mv))
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_merge_list_cells_b_matches_reference(k):
    rng = np.random.default_rng(10 + k)
    nbs = _nbr_sets(rng, 4096)
    names = ("a1", "b1", "b0", "a0", "b2")
    jc = {n: tuple(jnp.asarray(x) for x in c) for n, c in zip(names, nbs)}
    want = jax.jit(jb64._merge_list_cells_b, static_argnums=1)(jc, k)
    pf, mv = frame_b64.merge_list_cells_b({n: tuple(T(x) for x in c)
                                           for n, c in zip(names, nbs)}, k)
    for j, (wpf, wmv) in enumerate(want):
        eq(wpf, pf[j], f"pf slot {j}")
        eq(wmv, mv[j], f"mv slot {j}")
    if k == 5:
        # combined candidates (bi-predictive, none of the inputs, not zero)
        # and lists of five spatial or combined entries occur
        wpf = np.stack([np.asarray(p) for p, _ in want])
        wmv = np.stack([np.asarray(m) for _, m in want])
        inputs = [(c[1], c[2], c[0]) for c in nbs]
        comb = np.zeros(wpf.shape[:2], bool)
        for j in range(k):
            same = [a & (p == wpf[j]).all(-1) & (m == wmv[j]).reshape(-1, 4).all(-1)
                    for p, m, a in inputs]
            comb[j] = (wpf[j] == 1).all(-1) & wmv[j].reshape(-1, 4).any(-1) & ~np.any(same, 0)
        assert comb.any()
        assert (wmv[-1].reshape(-1, 4).any(-1) | ~(wpf[-1] == 1).all(-1)).any()


@pytest.mark.parametrize("lx", [0, 1])
@pytest.mark.parametrize("tb,td", [(2, -2), (1, -7), (4, -4), (-3, 5)])
def test_amvp_cells_b_matches_reference(lx, tb, td):
    rng = np.random.default_rng(100 + 10 * lx + tb)
    nbs = _nbr_sets(rng, 4096)
    a, b = [nbs[3], nbs[0]], [nbs[2], nbs[1], nbs[4]]
    fn = jax.jit(jb64._amvp_cells_b, static_argnums=2)
    want = fn([tuple(jnp.asarray(x) for x in c) for c in a],
              [tuple(jnp.asarray(x) for x in c) for c in b], lx, jnp.int32(tb), jnp.int32(td))
    got = frame_b64.amvp_cells_b([tuple(T(x) for x in c) for c in a],
                                 [tuple(T(x) for x in c) for c in b], lx, tb, td)
    for w, g in zip(want, got):
        eq(w, g)
    # neighbours that use only the other list were scaled into the result
    other = [(c[0] & (c[1][:, lx] == 0)) for c in a + b]
    assert np.any(other)


def _arb_inputs(rng, lanes: int, log2: int, k: int):
    n = 1 << log2
    span = n + 2 * SR + 7
    base = rng.integers(0, 256, (lanes, span + 8, span + 8))
    smooth = (base[:, :-8, :-8] + base[:, 8:, 8:] + base[:, 4:-4, 4:-4] * 2) // 4
    win0 = smooth.astype(np.uint8)
    win1 = np.clip(smooth + rng.integers(-6, 7, smooth.shape), 0, 255).astype(np.uint8)
    oy = np.clip(smooth[:, SR + 3:SR + 3 + n, SR + 5:SR + 5 + n]
                 + rng.integers(-4, 5, (lanes, n, n)), 0, 255).reshape(lanes, -1).astype(np.int32)
    nbs = _nbr_sets(rng, lanes)
    pf, mv = frame_b64.merge_list_cells_b(
        {nm: tuple(T(x) for x in c) for nm, c in zip(("a1", "b1", "b0", "a0", "b2"), nbs)}, k)
    me0 = rng.integers(-40, 41, (lanes, 2)).astype(np.int32)
    me1 = rng.integers(-40, 41, (lanes, 2)).astype(np.int32)
    mvps = [rng.integers(-40, 41, (lanes, 2)).astype(np.int32) for _ in range(4)]
    icost = rng.uniform(500, 20000, lanes).astype(np.float32)
    lamf = np.full(lanes, LAMBDA[30], np.float32)
    return dict(oy=oy, win0=win0, win1=win1, pf=pf.numpy(), mv=mv.numpy(), me0=me0, me1=me1,
                mvps=mvps, icost=icost, lamf=lamf)


def _arb_jax(x, log2: int, k: int):
    fn = jax.jit(lambda oy, w0, w1, pf, mv, m0, m1, p0, p1, p2, p3, ic, lam: jb64._arbitrate_b(
        jck, oy, log2, w0, w1, [(pf[j], mv[j]) for j in range(k)], m0, m1, (p0, p1), (p2, p3),
        ic, lam, k))
    out = fn(*(jnp.asarray(a) for a in (x["oy"], x["win0"], x["win1"], x["pf"], x["mv"],
                                        x["me0"], x["me1"], *x["mvps"], x["icost"],
                                        x["lamf"])))
    return {key: np.asarray(v) for key, v in out.items()}


def _arb_port(x, log2: int, k: int):
    p = x["mvps"]
    return frame_b64.arbitrate_b(T(x["oy"]), log2, T(x["win0"]), T(x["win1"]),
                                 (T(x["pf"]), T(x["mv"])), T(x["me0"]), T(x["me1"]),
                                 (T(p[0]), T(p[1])), (T(p[2]), T(p[3])), T(x["icost"]),
                                 T(x["lamf"]), k)


@pytest.mark.parametrize("log2", [4, 5, 6])
def test_arbitrate_b_matches_reference(log2):
    x = _arb_inputs(np.random.default_rng(log2), 17, log2, 5)
    want = _arb_jax(x, log2, 5)
    got = _arb_port(x, log2, 5)
    assert set(got) == set(want)
    for key in want:
        eq(want[key], got[key], key)


# --------------------------------------------------------- float32 rules

def _bits(rng, n):
    return costs.bits_of(T(rng.integers(-300, 301, n).astype(np.int32))).numpy()


def _rule_inputs(rng, n=200000):
    sat = rng.integers(0, 200000, n).astype(np.float32)
    lam = rng.uniform(1, 300, n).astype(np.float32)
    return sat, lam, _bits(rng, n), _bits(rng, n)


RULES = {
    # dense_cost and the arbitration's L0 / L1 costs: satd + lam * (bits + 5)
    "uni": (lambda s, l, b0, b1: s + l * (b0 + 5.0),
            lambda s, l, b0, b1: costs.fma(l, b0 + 5.0, s)),
    # their BI cost: satd + lam * (b0 + b1 + 7)
    "bi": (lambda s, l, b0, b1: s + l * (b0 + b1 + 7.0),
           lambda s, l, b0, b1: costs.fma(l, b0 + b1 + 7.0, s)),
    # the split rule's four CU16s: sum16 + lam^2 * 5
    "split": (lambda s, l, b0, b1: s + (l * l) * 5.0,
              lambda s, l, b0, b1: costs.fma(l * l, 5.0, s)),
    # the merge candidates: satd + lam * (2 + merge-index bits)
    "merge": (lambda s, l, b0, b1: s + l * (2.0 + jnp.floor(b0 / 8.0)),
              lambda s, l, b0, b1: costs.fma(l, 2.0 + torch.floor(b0 / 8.0), s)),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_b_cost_is_one_fma(rule, monkeypatch):
    """The reference's compiled cost is a single fused multiply-add: the
    port's equals it bit for bit; a multiply rounded before the add does
    not."""
    ref, port = RULES[rule]
    args = _rule_inputs(np.random.default_rng(len(rule)))
    want = np.asarray(jax.jit(ref)(*(jnp.asarray(a) for a in args))).view(np.int32)
    np.testing.assert_array_equal(port(*(T(a) for a in args)).numpy().view(np.int32), want)
    monkeypatch.setattr(costs, "fma", lambda a, b, c: a * b + c)
    assert (port(*(T(a) for a in args)).numpy().view(np.int32) != want).any()


def _tie_lanes(x, log2: int, k: int, a: int, b: int, lanes: int, ulps: int = 3):
    """Lanes whose lambda steps ulp by ulp across the value at which the
    arbitration's explicit costs a and b (0 L0, 1 L1, 2 BI) tie, from the
    port's SATDs and bits at lambda = 1."""
    ones = dict(x, lamf=np.ones_like(x["lamf"]))
    got = {}

    def spy_fma(l, bits, s):
        got.setdefault("calls", []).append((bits, s))
        return costs.fma(l, bits, s)

    orig = frame_b64.fma
    frame_b64.fma = spy_fma
    try:
        _arb_port(ones, log2, k)
    finally:
        frame_b64.fma = orig
    (bm, sm), *expl = got["calls"]  # merge costs, then L0, L1, BI
    (ba, sa), (bb, sb) = expl[a], expl[b]
    lam = (sb - sa) / (ba - bb)  # sa + lam ba == sb + lam bb
    rows = []
    for i in np.nonzero(((lam > 0.5) & (lam < 500)).numpy())[0]:
        l32 = np.float32(float(lam[i]))
        for u in range(-ulps, ulps + 1):
            lv = l32
            for _ in range(abs(u)):
                lv = np.nextafter(lv, np.float32(np.inf if u > 0 else -np.inf))
            rows.append((i, lv))
    idx = np.array([r[0] for r in rows])[:lanes]
    out = {key: x[key][idx] for key in ("oy", "win0", "win1", "me0", "me1")}
    out.update(mvps=[m[idx] for m in x["mvps"]], pf=x["pf"][:, idx], mv=x["mv"][:, idx])
    out["lamf"] = np.array([r[1] for r in rows], np.float32)[:lanes]
    out["icost"] = np.full(len(idx), 1e30, np.float32)
    return out


def test_arbitration_needs_the_fma_rule(monkeypatch):
    """On lanes whose lambda straddles a tie of two explicit costs, the
    port's choice of L0 / L1 / BI equals the reference's; replacing the
    fused multiply-adds by a multiply and an add flips some of them."""
    log2, k = 4, 2
    x = _arb_inputs(np.random.default_rng(77), 2048, log2, k)
    diff = 0
    for a, b in ((0, 2), (1, 2), (0, 1)):
        t = _tie_lanes(x, log2, k, a, b, 1024)
        want = _arb_jax(t, log2, k)
        got = _arb_port(t, log2, k)
        for key in want:
            eq(want[key], got[key], key)
        with monkeypatch.context() as mp:
            mp.setattr(frame_b64, "fma", lambda l, bits, s: l * bits + s)
            plain = _arb_port(t, log2, k)
        diff += int((plain["inter_dir"].numpy() != want["inter_dir"]).sum())
    assert diff > 0


def test_arbitration_tie_rules():
    """Exact ties, as the reference decides them: with lambda 0, equal
    windows and equal motion every candidate's cost is the same SATD, so
    argmin takes the first merge candidate and L0 before L1 and BI,
    `is_merge` holds on a tie (<=) and intra, at the same cost, loses
    (strict <)."""
    log2, k, lanes = 4, 5, 17
    x = _arb_inputs(np.random.default_rng(9), lanes, log2, k)
    x["win1"] = x["win0"]
    x["me1"] = x["me0"]
    x["pf"] = np.broadcast_to(np.array([1, 0], np.int32), x["pf"].shape).copy()
    x["mv"] = np.zeros_like(x["mv"])
    x["mv"][:, :, 0] = x["me0"][None]
    x["lamf"] = np.zeros_like(x["lamf"])
    sat = frame_b64.ck.satd_flat(frame_b64.uni_round(frame_b64.mc_luma_window_batch_14bit(
        T(x["win0"]), T(x["me0"]), 1 << log2, SR)).reshape(lanes, -1), T(x["oy"]), log2)
    x["icost"] = sat.to(torch.float32).numpy()
    want = _arb_jax(x, log2, k)
    got = _arb_port(x, log2, k)
    for key in want:
        eq(want[key], got[key], key)
    assert (want["merge_idx"] == 0).all() and want["is_merge"].all()
    assert not want["use_intra"].any()
    assert (want["inter_dir"] == 1).all()
