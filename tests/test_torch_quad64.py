"""The PyTorch port's CTB64 low-delay encode (`--ctu 64`) against the JAX
Encoder.

192x128 (3x2 CTBs), the moving sequence of tests/test_inter64_device.py
(`synthetic_frames(192, 128, 1, seed=5)` rolled by (3i, 5i)), IDR + 3 P at
QP 30, CTB64 quadtree with deblocking, at two points: merge 1 without SAO
and merge 5 with SAO, and the first with WPP (`--ctu 64 --wpp`, whose
device stage is the first point's: its JAX encode reuses that compile).
The port's Annex-B stream must be byte-identical to
the JAX `Encoder`'s frame by frame and its reconstruction element-identical;
the JAX `Decoder` must decode it to the port's reconstruction; a JAX
snapshot taken after the IDR frame must resume in the port.  Each JAX
configuration is encoded once (module fixture): its compile is the cost.
"""

import numpy as np
import pytest

from kvazzup_tpu.decoder.top import Decoder
from kvazzup_tpu.encoder.top import Encoder as JaxEncoder
from kvazzup_tpu.io.yuv import synthetic_frames, write_yuv420

from kvazzup_tpu_torch.encoder.top import Encoder
from kvazzup_tpu_torch.inputs import stream_config
from kvazzup_tpu_torch.ops import hopper_q

W, H, QP, NF = 192, 128, 30, 4
POINTS = ((1, False), (5, True))


def _cfg(merge=1, sao=False, **kw):
    cfg = stream_config(W, H, qp=QP, merge=merge, sao=sao, ctu=64)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def frames():
    f0 = synthetic_frames(W, H, 1, seed=5)[0]
    return [f0] + [tuple(np.roll(p, (3 * i, 5 * i), axis=(0, 1)) for p in f0)
                   for i in range(1, NF)]


@pytest.fixture(scope="module")
def runs(frames):
    """{(merge, sao): (jax streams, jax recons, port streams, port recons,
    the JAX snapshot after frame 0)}"""
    res = {}
    for merge, sao in POINTS:
        jenc = JaxEncoder(_cfg(merge, sao), intra_period=64)
        js, jr, snap = [], [], None
        for i, f in enumerate(frames):
            s, r = jenc.encode_frame(*f)
            js.append(s)
            jr.append(r)
            if i == 0:
                snap = jenc.snapshot()
        enc = Encoder(_cfg(merge, sao), intra_period=64, device="cpu")
        out = [enc.encode_frame(*f) for f in frames]
        res[merge, sao] = (js, jr, [s for s, _ in out], [r for _, r in out], snap)
    return res


@pytest.mark.parametrize("point", POINTS)
def test_stream_byte_identical(runs, point):
    js, jr, ts, tr, _ = runs[point]
    assert [len(s) for s in ts] == [len(s) for s in js]
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a == b, f"frame {i} differs"
    for i, (a, b) in enumerate(zip(jr, tr)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), pb, err_msg=f"recon frame {i}")


@pytest.fixture(scope="module")
def wpp_runs(frames, runs):
    """(jax streams, jax recons, port streams, port recons) of `--ctu 64
    --wpp` at merge 1 (after `runs`, whose merge-1 compile it reuses)."""
    jenc = JaxEncoder(_cfg(wpp=True), intra_period=64)
    jout = [jenc.encode_frame(*f) for f in frames]
    enc = Encoder(_cfg(wpp=True), intra_period=64, device="cpu")
    out = [enc.encode_frame(*f) for f in frames]
    return ([s for s, _ in jout], [r for _, r in jout], [s for s, _ in out],
            [r for _, r in out])


def test_wpp_stream_byte_identical(wpp_runs, runs):
    """WPP at CTB64: one substream per CTB row, entry points in the slice
    header; the port's stream equals the JAX Encoder's and its recon that
    of the stream without WPP."""
    js, jr, ts, tr = wpp_runs
    assert ts == js
    for a, b in zip(jr, tr):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), pb)
    plain_streams, _, _, plain_recons, _ = runs[1, False]
    assert all(a != b for a, b in zip(ts, plain_streams))
    for a, b in zip(tr, plain_recons):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, np.asarray(pb))


@pytest.mark.parametrize("point", POINTS)
def test_jax_decoder_reproduces_port_recon(runs, point):
    _, _, ts, tr, _ = runs[point]
    decoded = Decoder().decode(b"".join(ts))
    assert len(decoded) == NF
    for rec, dec in zip(tr, decoded):
        for a, b in zip(rec, dec):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("point", POINTS)
def test_snapshot_restore_from_jax(runs, frames, point):
    """The JAX encoder's state after the CTB64 IDR frame resumes in the
    port, whose P frames then equal the JAX encoder's."""
    js, _, _, _, snap = runs[point]
    enc = Encoder(_cfg(*point), intra_period=64, device="cpu")
    enc.restore(snap, "cpu")
    assert [enc.encode_frame(*f)[0] for f in frames[1:]] == js[1:]


def test_cli_ctu64_matches_encoder(frames, tmp_path, runs):
    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:2])
    out = tmp_path / "out.265"
    assert main(["encode", str(src), str(out), "--size", f"{W}x{H}", "--qp", str(QP),
                 "--ctu", "64", "--device", "cpu"]) == 0
    assert out.read_bytes() == b"".join(runs[1, False][0][:2])


@pytest.mark.parametrize("argv", [["--ctu", "32"], ["--ctu", "64", "--slices", "2"],
                                  ["--ctu", "64", "--bitdepth", "10"],
                                  ["--ctu", "64", "--gop", "ra", "--cutree", "1"],
                                  ["--ctu", "64", "--tiles", "2"]])
def test_cli_unported_ctb64_options_raise(frames, tmp_path, argv):
    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:1])
    with pytest.raises(NotImplementedError):
        main(["encode", str(src), str(tmp_path / "o.265"), "--size", f"{W}x{H}", *argv,
              "--device", "cpu"])


@pytest.mark.parametrize("kw", [dict(fast_decision=False), dict(max_tb_log2=4), dict(min_cb_log2=4),
                                dict(cu_qp_delta=True), dict(slices=2), dict(tile_cols=2),
                                dict(bit_depth=10), dict(max_transform_hierarchy_depth_intra=1),
                                dict(ctb_log2=5)])
def test_unported_ctb64_configs_raise(kw):
    with pytest.raises(NotImplementedError):
        Encoder(_cfg(**kw), intra_period=64, device="cpu")


def test_cpu_encode_launches_no_kernel(frames):
    hopper_q.reset_launches()
    enc = Encoder(_cfg(), intra_period=64, device="cpu")
    for f in frames[:2]:
        enc.encode_frame(*f)
    assert hopper_q.LAUNCHES == {"quant": 0, "dequant": 0, "satd": 0, "residual": 0}
