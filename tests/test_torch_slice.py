"""The PyTorch port's default low-delay encode against the JAX Encoder.

96x64, `synthetic_frames(96, 64, 4, seed=12)`, IDR + 3 P at QP 30 with the
CLI's defaults (CTB16, deblocking on): the port's Annex-B stream must be
byte-identical to the JAX `Encoder`'s, for merge 1 and merge 5; the JAX
`Decoder` must decode it to the port's reconstruction; the encoder state
must carry over from JAX to the port; the port's `PipelinedEncoder`,
`vps_period`, CLI `--bitrate` and rate controller must equal their JAX
counterparts; and the port must import neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from kvazzup_tpu.core.params import StreamConfig
from kvazzup_tpu.decoder.top import Decoder
from kvazzup_tpu.encoder.top import Encoder as JaxEncoder
from kvazzup_tpu.io.yuv import synthetic_frames, write_yuv420

from kvazzup_tpu_torch.encoder.top import Encoder
from kvazzup_tpu_torch.ops import hopper_q

W, H, QP, NF = 96, 64, 30, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(merge=1, **kw):
    return StreamConfig.for_source(W, H, qp=QP, merge_cand=merge, **kw)


def _encode(enc, frames):
    out = [enc.encode_frame(y, u, v) for (y, u, v) in frames]
    return [s for s, _ in out], [r for _, r in out]


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(W, H, NF, seed=12)


@pytest.fixture(scope="module")
def runs(frames):
    """{merge: (jax_streams, jax_recons, port_streams, port_recons)}"""
    res = {}
    for merge in (1, 5):
        js, jr = _encode(JaxEncoder(_cfg(merge), intra_period=64), frames)
        ts, tr = _encode(Encoder(_cfg(merge), intra_period=64, device="cpu"), frames)
        res[merge] = (js, jr, ts, tr)
    return res


@pytest.mark.parametrize("merge", [1, 5])
def test_stream_byte_identical(runs, merge):
    js, jr, ts, tr = runs[merge]
    assert [len(s) for s in ts] == [len(s) for s in js]
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a == b, f"frame {i} differs"
    for i, (a, b) in enumerate(zip(jr, tr)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), pb, err_msg=f"recon frame {i}")


@pytest.mark.parametrize("merge", [1, 5])
def test_jax_decoder_reproduces_port_recon(runs, merge):
    _, _, ts, tr = runs[merge]
    decoded = Decoder().decode(b"".join(ts))
    assert len(decoded) == NF
    for rec, dec in zip(tr, decoded):
        for a, b in zip(rec, dec):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_snapshot_restore_from_jax(runs, frames):
    """JAX encodes frames 0..1, the port resumes from its snapshot."""
    js = runs[1][0]
    jenc = JaxEncoder(_cfg(), intra_period=64)
    for (y, u, v) in frames[:2]:
        jenc.encode_frame(y, u, v)
    enc = Encoder(_cfg(), intra_period=64, device="cpu")
    enc.restore(jenc.snapshot(), "cpu")
    got = [enc.encode_frame(y, u, v)[0] for (y, u, v) in frames[2:]]
    assert got == js[2:]
    # and the port's own snapshot round-trips
    enc2 = Encoder(_cfg(), intra_period=64, device="cpu")
    enc2.restore(enc.snapshot())
    assert enc2.snapshot()["frame_count"] == NF


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_encoder_matches_jax_encoder(runs, frames, depth):
    """The port's PipelinedEncoder on the CPU: the JAX Encoder's bytes and
    recon, frame by frame, at one and three frames in flight."""
    from kvazzup_tpu_torch.encoder.pipelined import PipelinedEncoder

    js, jr, _, _ = runs[1]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the three threads finely
    try:
        with PipelinedEncoder(_cfg(), intra_period=64, depth=depth, device="cpu") as pe:
            got = []
            for i, f in enumerate(frames):
                got += pe.push(*f)
                assert len(got) >= i + 1 - depth  # at most `depth` frames in flight
            got += pe.flush()
            assert pe.stage["frames"] == NF and pe.stage["fetch_bytes"] > 0
    finally:
        sys.setswitchinterval(switch)
    assert [s for s, _ in got] == js
    for (_, a), b in zip(got, jr):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, np.asarray(pb))


def test_vps_period_matches_jax_encoder(frames):
    """Headers re-sent at every IDR (vps_period 1, an IDR every 2 frames),
    byte-identical to the JAX Encoder."""
    jenc = JaxEncoder(_cfg(), intra_period=2, vps_period=1)
    js = [jenc.encode_frame(*f)[0] for f in frames]
    enc = Encoder(_cfg(), intra_period=2, device="cpu", vps_period=1)
    ts = [enc.encode_frame(*f)[0] for f in frames]
    assert ts == js
    headers = enc.headers()
    assert [s.startswith(headers) for s in ts] == [True, False, True, False]


def test_cli_bitrate_matches_jax_cli(frames, tmp_path, runs):
    """`--bitrate` drives the rate controller per frame as the JAX CLI does:
    the same QP sequence, so the same stream."""
    from kvazzup_tpu.cli import main as jax_main

    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames)
    flags = ["--size", f"{W}x{H}", "--qp", str(QP), "--bitrate", "24000", "--fps", "25"]
    jout, tout = tmp_path / "jax.265", tmp_path / "port.265"
    assert jax_main(["encode", str(src), str(jout), *flags]) == 0
    assert main(["encode", str(src), str(tout), *flags, "--device", "cpu"]) == 0
    assert tout.read_bytes() == jout.read_bytes()
    assert tout.read_bytes() != b"".join(runs[1][0])  # the QP moved


def test_rate_controller_matches_jax():
    """The port's copy of the rate controller gives the JAX one's QPs when
    fed the same bit counts, live retargeting included."""
    from kvazzup_tpu.pipeline.rate_control import RateController as JaxRC

    from kvazzup_tpu_torch.pipeline.rate_control import RateController

    rng = np.random.default_rng(4)
    rcs = [RateController(1_500_000, 30, base_qp=32), JaxRC(1_500_000, 30, base_qp=32)]
    qps = [[], []]
    for i in range(120):
        is_idr = i % 32 == 0
        bits = float(rng.integers(20_000, 400_000 if is_idr else 120_000))
        if i == 60:
            for rc in rcs:
                rc.retarget(600_000)
        for rc, q in zip(rcs, qps):
            q.append(rc.frame_qp(is_idr))
            rc.update(q[-1], bits, is_idr)
    assert qps[0] == qps[1]
    assert len(set(qps[0])) > 5


def test_cpu_encode_launches_no_kernel(frames):
    hopper_q.reset_launches()
    Encoder(_cfg(), intra_period=64, device="cpu").encode_frame(*frames[0])
    assert hopper_q.LAUNCHES == {"quant": 0, "dequant": 0, "satd": 0, "residual": 0}


@pytest.mark.parametrize("kw", [dict(slices=2), dict(cu_qp_delta=True),
                                dict(ctb_log2=5, min_cb_log2=3, max_tb_log2=5),
                                dict(max_transform_hierarchy_depth_intra=1), dict(bit_depth=10),
                                dict(fast_decision=False)])
def test_unported_configs_raise(kw):
    with pytest.raises(NotImplementedError):
        Encoder(_cfg(**kw), intra_period=64, device="cpu")


def test_cli_encode_matches_encoder(frames, tmp_path, runs):
    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:2])
    out = tmp_path / "out.265"
    assert main(["encode", str(src), str(out), "--size", f"{W}x{H}", "--qp", str(QP),
                 "--device", "cpu"]) == 0
    assert out.read_bytes() == b"".join(runs[1][0][:2])
    with pytest.raises(NotImplementedError):
        main(["encode", str(src), str(out), "--size", f"{W}x{H}", "--slices", "2",
              "--device", "cpu"])


def _port_modules():
    root = os.path.join(REPO, "kvazzup_tpu_torch")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_imports_no_jax():
    """Importing every module of the port, and encoding a frame with its
    native CABAC, loads neither JAX nor any module of the JAX package."""
    mods = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
            for p in _port_modules()]
    mods = sorted(m for m in mods if not m.endswith("__main__"))
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from kvazzup_tpu_torch.encoder.top import Encoder\n"
        "from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames\n"
        "f = synthetic_frames(32, 32, 1, seed=1)[0]\n"
        "Encoder(stream_config(32, 32, sao=True), device='cpu').encode_frame(*f)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'kvazzup_tpu')\n"
        "             or m.startswith(('jax.', 'kvazzup_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_port_sources_import_no_jax_package():
    """No module of the port names jax or kvazzup_tpu in an import, at the
    top or inside a function."""
    import ast

    bad = []
    for path in _port_modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                names = [a.name for a in n.names]
            elif isinstance(n, ast.ImportFrom) and n.level == 0:
                names = [n.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{n.lineno} {m}" for m in names
                    if m.split(".")[0] in ("jax", "jaxlib", "kvazzup_tpu")]
    assert not bad, bad


def test_native_cabac_builds_in_the_port_and_raises_on_failure(monkeypatch, tmp_path):
    """The port's native CABAC library lives in kvazzup_tpu_torch/build/; a
    failed build raises instead of leaving the encoder on the Python tier."""
    from kvazzup_tpu_torch import native

    lib = native.get_lib()
    assert os.path.dirname(lib._name) == os.path.join(REPO, "kvazzup_tpu_torch", "build")

    def failing_run(cmd, check=False, **kw):
        if check:
            raise subprocess.CalledProcessError(1, cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "no compiler")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", failing_run)
    with pytest.raises(RuntimeError, match="no compiler"):
        native.get_lib()
    assert native._LIB is None


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the encoder, its inputs and the kernels through
    kvazzup_tpu_torch alone, never through JAX or the JAX package."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    ours = [m for m in names if m.split(".")[0] in ("jax", "kvazzup_tpu", "kvazzup_tpu_torch")]
    assert ours and all(m.split(".")[0] == "kvazzup_tpu_torch" for m in ours), ours
