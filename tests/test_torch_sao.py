"""The port's SAO (kvazzup_tpu_torch/ops/sao.py) and its CTB16 SAO + WPP
encode against the JAX reference, tolerance 0 throughout.

Ops: seeded original / deblocked planes (noise, flat, near-flat, gradient)
go through the JAX `sao_statistics`, `sao_decide`, `sao_decide_chroma` and
`sao_apply` (the XLA form, and the Pallas strip kernel in interpret mode)
and through the port's counterparts.  Slice: `synthetic_frames(96, 64, 4,
seed=12)`, IDR + 3 P at QP 30 with SAO + WPP (merge 1 and 3) and with WPP
alone; the port's stream and reconstruction must be byte-identical to the
JAX `Encoder`'s, and the JAX `Decoder` must reproduce the port's recon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazzup_tpu.core.params import StreamConfig
from kvazzup_tpu.decoder.top import Decoder
from kvazzup_tpu.encoder.top import Encoder as JaxEncoder
from kvazzup_tpu.io.yuv import synthetic_frames, write_yuv420
from kvazzup_tpu.ops import sao as jsao

from kvazzup_tpu_torch.encoder.top import Encoder
from kvazzup_tpu_torch.ops import sao as tsao

W, H, QP, NF = 96, 64, 30, 4
QPS = (22, 27, 32, 37, 42)
KINDS = ("noise", "flat", "near_flat", "gradient")
CONFIGS = {"sao_merge1": dict(sao_enabled=True, wpp=True, merge_cand=1),
           "sao_merge3": dict(sao_enabled=True, wpp=True, merge_cand=3),
           "wpp_only": dict(wpp=True)}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lam(qp):
    return float(0.57 * 2.0 ** ((qp - 12) / 3.0))


def _planes(kind, h, w, seed):
    """(orig, deblocked recon) uint8 planes; flat and near-flat ones force
    cost ties between classes, band windows and the off decision."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        o = rng.integers(0, 256, (h, w))
        r = o + rng.integers(-9, 10, (h, w))
    elif kind == "flat":
        o = np.full((h, w), 128)
        r = o.copy()
    elif kind == "near_flat":
        o = 100 + rng.integers(0, 2, (h, w))
        r = np.full((h, w), 100)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        o = (2 * xx + yy) % 256 + rng.integers(-3, 4, (h, w))
        r = o + rng.integers(-4, 5, (h, w)) + 3 * (rng.random((h, w)) < 0.3)
    return np.clip(o, 0, 255).astype(np.uint8), np.clip(r, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ the ops


def test_best_offset_every_ctb_sum_and_count():
    """round(sum / count) in float32 (half to even) and the offset choice
    agree for every sum and count a 16x16 CTB can produce (|sum| <= 256 *
    255, count <= 256)."""
    def ref(s, c):
        o, d = jsao._best_offset(s, c, -7, 7)
        lo = jnp.array([0, -7], jnp.int32)[None, :]
        hi = jnp.array([7, 0], jnp.int32)[None, :]
        oe, de = jsao._best_offset(s[:, :2], c[:, :2], lo, hi)
        return jnp.round(s / jnp.maximum(c, 1)), o, d, oe, de

    ref = jax.jit(ref)
    ssum = np.arange(-256 * 255, 256 * 255 + 1, dtype=np.int32)
    lo, hi = T(np.array([0, -7], np.int32))[None, :], T(np.array([7, 0], np.int32))[None, :]
    for c0 in range(0, 257, 16):
        s, c = np.meshgrid(ssum, np.arange(c0, c0 + 16, dtype=np.int32), indexing="ij")
        want = [np.asarray(x) for x in ref(jnp.asarray(s), jnp.asarray(c))]
        ts, tc = T(s), T(c)
        mean = torch.round(ts.to(torch.float32) / tc.clamp(min=1).to(torch.float32))
        got = [mean, *tsao._best_offset(ts, tc, -7, 7),
               *tsao._best_offset(ts[:, :2], tc[:, :2], lo, hi)]
        for wv, gv in zip(want, got):
            np.testing.assert_array_equal(wv, gv.numpy(), err_msg=f"counts {c0}..{c0 + 15}")


@pytest.mark.parametrize("ctb", [16, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_statistics_match(kind, ctb):
    h, w = (H, W) if ctb == 16 else (H // 2, W // 2)
    o, r = _planes(kind, h, w, seed=ctb)
    want = jsao.sao_statistics(jnp.asarray(o), jnp.asarray(r), ctb=ctb)
    got = tsao.sao_statistics(T(o), T(r), ctb=ctb)
    for k in ("eo_sum", "eo_cnt", "band_sum", "band_cnt"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(), err_msg=k)


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("kind", KINDS)
def test_decide_matches(kind, qp):
    o, r = _planes(kind, H, W, seed=qp)
    want = jsao.sao_decide(jnp.asarray(o), jnp.asarray(r), _lam(qp), ctb=16)
    got = tsao.sao_decide(T(o), T(r), _lam(qp), ctb=16)
    for name, a, b in zip(("typ", "aux", "offs"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    # the RD cost, bit for bit: the fused multiply-add shows here first
    np.testing.assert_array_equal(np.asarray(want[3]).view(np.int32),
                                  got[3].numpy().view(np.int32), err_msg="cost")

    planes = [_planes(kind, H // 2, W // 2, seed=100 * qp + c) for c in (0, 1)]
    args = (planes[0][0], planes[0][1], planes[1][0], planes[1][1])
    want = jsao.sao_decide_chroma(*(jnp.asarray(a) for a in args), _lam(qp), ctb=8)
    got = tsao.sao_decide_chroma(*(T(a) for a in args), _lam(qp), ctb=8)
    for name, a, b in zip(("typ", "cls", "aux_cb", "aux_cr", "offs_cb", "offs_cr"),
                          want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"chroma {name}")


def _apply_params(mode, cbh, cbw, seed):
    rng = np.random.default_rng(seed)
    typ = {"mixed": rng.integers(0, 3, (cbh, cbw)),
           "edge": np.full((cbh, cbw), 2),
           "band": np.full((cbh, cbw), 1)}[mode].astype(np.int32)
    aux = np.where(typ == 2, rng.integers(0, 4, (cbh, cbw)),
                   rng.integers(0, 29, (cbh, cbw))).astype(np.int32)
    offs = rng.integers(-7, 8, (cbh, cbw, 4)).astype(np.int32)
    return typ, aux, offs


@pytest.mark.parametrize("ctb", [8, 16])
@pytest.mark.parametrize("mode", ["mixed", "edge", "band"])
def test_apply_plain_matches(mode, ctb):
    """Against the reference's XLA form and its Pallas strip kernel (interpret
    mode); a plane of several CTB rows and columns, every EO class and band
    window."""
    rng = np.random.default_rng(ctb)
    h, w = 4 * ctb, 6 * ctb
    rec = rng.integers(0, 256, (h, w)).astype(np.uint8)
    typ, aux, offs = _apply_params(mode, h // ctb, w // ctb, seed=ctb + len(mode))
    jargs = (jnp.asarray(typ), jnp.asarray(aux), jnp.asarray(offs))
    xla = np.asarray(jsao.sao_apply(jnp.asarray(rec), *jargs, ctb=ctb))
    pallas = np.asarray(jsao._sao_apply_pallas(jnp.asarray(rec, jnp.int32), *jargs, ctb=ctb,
                                               interpret=True))
    got = tsao.sao_apply_plain(T(rec), T(typ), T(aux), T(offs), ctb=ctb)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(xla, got.numpy())
    np.testing.assert_array_equal(pallas, got.numpy())
    assert not np.array_equal(rec, got.numpy())  # the parameters did something


def test_apply_wrapper_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no launch;
    what the kernel does not take raises."""
    rng = np.random.default_rng(3)
    rec = T(rng.integers(0, 256, (32, 48)).astype(np.uint8))
    typ, aux, offs = (T(a) for a in _apply_params("mixed", 2, 3, seed=3))
    tsao.reset_launches()
    got = tsao.sao_apply(rec, typ, aux, offs, ctb=16)
    assert torch.equal(got, tsao.sao_apply_plain(rec, typ, aux, offs, ctb=16))
    assert tsao.LAUNCHES == {"sao": 0}
    with pytest.raises(NotImplementedError):
        tsao.sao_apply(rec, typ, aux, offs, ctb=16, xpad=16)
    with pytest.raises(NotImplementedError):
        tsao.sao_apply(rec, typ, aux, offs, ctb=16, lvalid=True)
    with pytest.raises(TypeError):  # bd 10 takes uint16 planes
        tsao.sao_apply(rec, typ, aux, offs, ctb=16, bd=10)
    with pytest.raises(TypeError):
        tsao.sao_apply(rec.to(torch.int32), typ, aux, offs, ctb=16)
    with pytest.raises(ValueError):
        tsao.sao_apply(rec, typ[:1].contiguous(), aux, offs, ctb=16)


def test_apply_planes_matches_plane_calls_and_reference():
    """The three-plane wrapper on CPU tensors: luma at ctb 16 and both chroma
    planes at ctb 8, as the encoder calls it, equal three `sao_apply_plain`
    calls and the reference's `sao_apply` on each plane."""
    rng = np.random.default_rng(9)
    planes = []
    for k, (h, w, ctb) in enumerate(((64, 96, 16), (32, 48, 8), (32, 48, 8))):
        rec = rng.integers(0, 256, (h, w)).astype(np.uint8)
        planes.append((rec, *_apply_params("mixed", h // ctb, w // ctb, seed=30 + k), ctb))
    tsao.reset_launches()
    got = tsao.sao_apply_planes([(T(r), T(t), T(a), T(o), c) for r, t, a, o, c in planes])
    assert tsao.LAUNCHES == {"sao": 0}
    for (rec, typ, aux, offs, ctb), g in zip(planes, got):
        want = np.asarray(jsao.sao_apply(jnp.asarray(rec), jnp.asarray(typ), jnp.asarray(aux),
                                         jnp.asarray(offs), ctb=ctb))
        np.testing.assert_array_equal(want, g.numpy())
        assert torch.equal(g, tsao.sao_apply_plain(T(rec), T(typ), T(aux), T(offs), ctb=ctb))
        assert not np.array_equal(rec, g.numpy())


@pytest.mark.parametrize("ctb", [8, 16])
@pytest.mark.parametrize("mode", ["mixed", "edge", "band"])
def test_apply_plain_bd10_matches(mode, ctb):
    """The 10-bit mode on CTB-aligned planes: uint16 in and out, equal to the
    reference's XLA form and its Pallas strip kernel (interpret mode) at
    bd 10."""
    rng = np.random.default_rng(40 + ctb)
    h, w = 4 * ctb, 6 * ctb
    rec = rng.integers(0, 1024, (h, w)).astype(np.uint16)
    typ, aux, offs = _apply_params(mode, h // ctb, w // ctb, seed=50 + ctb + len(mode))
    jargs = (jnp.asarray(typ), jnp.asarray(aux), jnp.asarray(offs))
    xla = np.asarray(jsao._sao_apply_xla(jnp.asarray(rec), *jargs, ctb=ctb, bd=10))
    pallas = np.asarray(jsao._sao_apply_pallas(jnp.asarray(rec, jnp.int32), *jargs, ctb=ctb,
                                               bd=10, interpret=True))
    got = tsao.sao_apply_plain(T(rec), T(typ), T(aux), T(offs), ctb=ctb, bd=10)
    assert got.dtype == torch.uint16 and xla.dtype == np.uint16
    np.testing.assert_array_equal(xla, got.numpy())
    np.testing.assert_array_equal(pallas, got.numpy())
    assert not np.array_equal(rec, got.numpy())


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("ctb", [8, 16])
def test_apply_unaligned_plane_matches(ctb, bd):
    """A 76x140 plane is no multiple of the CTB: the parameter grids are
    ceil-sized and the plain version and the wrapper equal the reference's
    XLA form, which crops the upsampled parameters to the plane."""
    rng = np.random.default_rng(60 + ctb + bd)
    h, w = 76, 140
    cbh, cbw = -(-h // ctb), -(-w // ctb)
    assert h % ctb or w % ctb
    dt = np.uint8 if bd == 8 else np.uint16
    rec = rng.integers(0, 1 << bd, (h, w)).astype(dt)
    typ, aux, offs = _apply_params("mixed", cbh, cbw, seed=70 + ctb + bd)
    want = np.asarray(jsao._sao_apply_xla(jnp.asarray(rec), jnp.asarray(typ), jnp.asarray(aux),
                                          jnp.asarray(offs), ctb=ctb, bd=bd))
    got = tsao.sao_apply_plain(T(rec), T(typ), T(aux), T(offs), ctb=ctb, bd=bd)
    np.testing.assert_array_equal(want, got.numpy())
    assert got.numpy().dtype == want.dtype == dt
    tsao.reset_launches()
    assert torch.equal(tsao.sao_apply(T(rec), T(typ), T(aux), T(offs), ctb=ctb, bd=bd), got)
    assert tsao.LAUNCHES == {"sao": 0}


def test_apply_planes_bd10_on_cpu():
    """Three uint16 planes through the three-plane wrapper at bd 10 equal
    three plain calls; a uint8 plane at bd 10 raises."""
    rng = np.random.default_rng(11)
    planes = []
    for k, (h, w, ctb) in enumerate(((76, 140, 16), (38, 70, 8), (38, 70, 8))):
        rec = T(rng.integers(0, 1024, (h, w)).astype(np.uint16))
        cbh, cbw = -(-h // ctb), -(-w // ctb)
        planes.append((rec, *(T(a) for a in _apply_params("mixed", cbh, cbw, seed=80 + k)), ctb))
    got = tsao.sao_apply_planes(planes, bd=10)
    for (rec, typ, aux, offs, ctb), g in zip(planes, got):
        assert torch.equal(g, tsao.sao_apply_plain(rec, typ, aux, offs, ctb=ctb, bd=10))
    with pytest.raises(TypeError):
        tsao.sao_apply_planes([(planes[0][0].to(torch.uint8), *planes[0][1:])], bd=10)


# ---------------------------------------------------------------- the slice


def _cfg(**kw):
    return StreamConfig.for_source(W, H, qp=QP, **kw)


def _encode(enc, frames):
    out = [enc.encode_frame(y, u, v) for (y, u, v) in frames]
    return [s for s, _ in out], [r for _, r in out]


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(W, H, NF, seed=12)


@pytest.fixture(scope="module")
def runs(frames):
    """{config: (jax_streams, jax_recons, port_streams, port_recons)}"""
    res = {}
    for name, kw in CONFIGS.items():
        js, jr = _encode(JaxEncoder(_cfg(**kw), intra_period=64), frames)
        ts, tr = _encode(Encoder(_cfg(**kw), intra_period=64, device="cpu"), frames)
        res[name] = (js, jr, ts, tr)
    return res


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_byte_identical(runs, name):
    js, jr, ts, tr = runs[name]
    assert [len(s) for s in ts] == [len(s) for s in js]
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a == b, f"frame {i} differs"
    for i, (a, b) in enumerate(zip(jr, tr)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), pb, err_msg=f"recon frame {i}")


@pytest.mark.parametrize("name", ["sao_merge1", "sao_merge3"])
def test_jax_decoder_reproduces_port_recon(runs, name):
    _, _, ts, tr = runs[name]
    decoded = Decoder().decode(b"".join(ts))
    assert len(decoded) == NF
    for rec, dec in zip(tr, decoded):
        for a, b in zip(rec, dec):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_snapshot_restore_from_jax(runs, frames):
    """JAX encodes frames 0..1 with SAO, the port resumes from its snapshot
    (the post-SAO reference picture and the counters)."""
    kw = CONFIGS["sao_merge1"]
    jenc = JaxEncoder(_cfg(**kw), intra_period=64)
    for (y, u, v) in frames[:2]:
        jenc.encode_frame(y, u, v)
    enc = Encoder(_cfg(**kw), intra_period=64, device="cpu")
    enc.restore(jenc.snapshot(), "cpu")
    got = [enc.encode_frame(y, u, v)[0] for (y, u, v) in frames[2:]]
    assert got == runs["sao_merge1"][0][2:]


def test_cli_sao_matches_encoder(frames, tmp_path, runs):
    """`encode --sao` sets WPP as the JAX CLI does and writes the Encoder's
    bytes; the CPU run launches no kernel."""
    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:2])
    out = tmp_path / "out.265"
    tsao.reset_launches()
    assert main(["encode", str(src), str(out), "--size", f"{W}x{H}", "--qp", str(QP),
                 "--sao", "--device", "cpu"]) == 0
    assert out.read_bytes() == b"".join(runs["sao_merge1"][0][:2])
    assert tsao.LAUNCHES == {"sao": 0}


def test_sao_without_wpp_raises():
    with pytest.raises(NotImplementedError, match="SAO requires"):
        Encoder(_cfg(sao_enabled=True), intra_period=64, device="cpu")
