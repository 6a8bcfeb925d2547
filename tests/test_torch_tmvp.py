"""The PyTorch port's TMVP (CTB16 and CTB64) and CTB64 WPP against the JAX
Encoder.

192x128 (CTB64: 3x2 CTBs, so a colBr cell crosses into the second CTB
row), `synthetic_frames(192, 128, 4, seed=5)`, IDR + 3 P at QP 30, four
configurations of the JAX CLI: the production combo `--ctu 64 --wpp --sao
--merge 5 --tmvp`, and CTB16 `--tmvp` at merge 1 and at merge 5 with and
without `--sao` (`--ctu 64 --wpp` at merge 1 is in test_torch_quad64.py,
where its JAX encode reuses a compile).  Tolerance 0: the port's Annex-B stream
must be byte-identical to the JAX `Encoder`'s frame by frame and its
reconstruction element-identical; the coded decisions with TMVP must
equal those without it in P1 (whose reference is an IDR: no temporal
candidate) and differ in a later P frame (the temporal candidate was
chosen, not only computed); the temporal candidate lists must equal the
JAX functions; a
JAX snapshot taken after IDR + P1, which carries a collocated motion
store, must resume in the port.  Each JAX configuration is encoded once,
in a module fixture.  The JAX package is imported only by fixtures, so
the `cuda` case (the production combo on the card against the port on
the CPU) runs on a machine without JAX:

    python -m pytest tests/test_torch_tmvp.py -m cuda --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch

from kvazzup_tpu_torch.encoder import frame_inter, frame_inter32, frame_inter64
from kvazzup_tpu_torch.encoder.top import Encoder
from kvazzup_tpu_torch.entropy.quad import _serialize_trees
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames

W, H, QP, NF = 192, 128, 30, 4
CONFIGS = {
    "ctb64 wpp sao merge5 tmvp": dict(ctu=64, wpp=True, sao=True, merge=5, tmvp=True),
    "ctb16 tmvp": dict(tmvp=True),
    "ctb16 merge5 tmvp": dict(merge=5, tmvp=True),
    "ctb16 merge5 tmvp sao": dict(merge=5, tmvp=True, sao=True),
}
PROD = "ctb64 wpp sao merge5 tmvp"
# configuration -> the frame after which the JAX snapshot is taken
SNAPSHOTS = {PROD: 1, "ctb16 merge5 tmvp": 1}


def _cfg(name, **over):
    return stream_config(W, H, qp=QP, **{**CONFIGS[name], **over})


def _decisions(cfg, ctx):
    """A P frame's coded decisions as one int array (None for an IDR):
    CTB16 per-CTU type, merge index, MVP flag, MVD and MV; CTB64 the
    quadtree's token stream (splits, types, merge indices, MVDs, MVP
    flags)."""
    out = ctx["out"]
    if ctx["kind"] == "quad_p":
        return _serialize_trees(cfg, out["trees"], 1)[0]
    if ctx["kind"] == "p":
        return np.concatenate([out[k].cpu().numpy().reshape(-1)
                               for k in ("ctype", "merge_idx", "mvp_flag", "mvd", "mv")])
    return None


def _port_encode(cfg, frames, device="cpu"):
    """(streams, recons, decisions) of the port's encode of frames."""
    enc = Encoder(cfg, intra_period=64, device=device)
    streams, recons, decisions = [], [], []
    for f in frames:
        ctx = enc.encode_frame_device(*f)
        decisions.append(_decisions(cfg, ctx))
        s, r = enc.encode_frame_entropy(ctx)
        streams.append(s)
        recons.append(r)
    return streams, recons, decisions


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(W, H, NF, seed=5)


@pytest.fixture(scope="module")
def jax_runs(frames):
    """{config: (streams, recons, the snapshot of SNAPSHOTS or None)}"""
    from kvazzup_tpu.encoder.top import Encoder as JaxEncoder

    res = {}
    for name in CONFIGS:
        jenc = JaxEncoder(_cfg(name), intra_period=64)
        js, jr, snap = [], [], None
        for i, f in enumerate(frames):
            s, r = jenc.encode_frame(*f)
            js.append(s)
            jr.append(r)
            if SNAPSHOTS.get(name) == i:
                snap = jenc.snapshot()
        res[name] = (js, jr, snap)
    return res


@pytest.fixture(scope="module")
def port_runs(frames):
    return {name: _port_encode(_cfg(name), frames) for name in CONFIGS}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_byte_identical(jax_runs, port_runs, name):
    js, jr, _ = jax_runs[name]
    ts, tr, _ = port_runs[name]
    assert [len(s) for s in ts] == [len(s) for s in js]
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a == b, f"frame {i} differs"
    for i, (a, b) in enumerate(zip(jr, tr)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), pb, err_msg=f"recon frame {i}")


@pytest.mark.parametrize("name", [PROD, "ctb16 merge5 tmvp"])
def test_tmvp_changes_the_stream(port_runs, frames, name):
    """The temporal candidate is chosen, not only computed: P1 reads an
    IDR's (all-intra) store and codes as without TMVP; P2, the first P
    frame with a motion store behind it, codes differently (merge
    indices, MVP flags), and so does its stream."""
    ts, _, dec = port_runs[name]
    off, _, dec_off = _port_encode(_cfg(name, tmvp=False), frames[:3])
    np.testing.assert_array_equal(dec[1], dec_off[1])
    assert not np.array_equal(dec[2], dec_off[2])
    assert len(ts[2]) != len(off[2])


@pytest.mark.parametrize("name", list(SNAPSHOTS))
def test_snapshot_with_col_store_resumes(jax_runs, frames, name):
    """A JAX snapshot after IDR + P1 carries P1's motion store; the port
    restores it and encodes P2 and P3 byte-identically."""
    js, _, snap = jax_runs[name]
    assert snap["col"] is not None and np.asarray(snap["col"][1]).any()
    enc = Encoder(_cfg(name), intra_period=64, device="cpu")
    enc.restore(snap, "cpu")
    assert [enc.encode_frame(*f)[0] for f in frames[2:]] == js[2:]
    col = enc.snapshot()["col"]
    assert col[0].dtype == np.int32 and col[1].shape == col[0].shape[:1]


def test_cli_production_combo(frames, tmp_path, jax_runs):
    from kvazzup_tpu.io.yuv import write_yuv420

    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:2])
    out = tmp_path / "out.265"
    assert main(["encode", str(src), str(out), "--size", f"{W}x{H}", "--qp", str(QP),
                 "--ctu", "64", "--wpp", "--sao", "--merge", "5", "--tmvp",
                 "--device", "cpu"]) == 0
    assert out.read_bytes() == b"".join(jax_runs[PROD][0][:2])


# ---------------------------------------------------- the candidate lists


def _store(rng, n16):
    """A 16-grid motion store: inter and intra cells, MVs that repeat."""
    mv = rng.integers(-6, 7, (n16, 2)).astype(np.int32)
    inter = (rng.random(n16) < 0.6).astype(np.int32)
    return mv, inter


@pytest.mark.parametrize("cw,ch,seed", [(3, 2, 0), (3, 2, 1), (2, 3, 2), (1, 1, 3)])
def test_temporal_cells_match_reference(cw, ch, seed):
    import jax.numpy as jnp

    from kvazzup_tpu.encoder.frame_inter64 import _temporal_cells

    mv, inter = _store(np.random.default_rng(seed), 16 * cw * ch)
    want = _temporal_cells(jnp.asarray(mv), jnp.asarray(inter), cw, ch)
    got = frame_inter64.temporal_cells(T(mv), T(inter), cw, ch)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pairs(rng, n, lanes):
    """n (avail, mv) pairs with small MVs, so that pruning pairs collide."""
    return [(rng.random(lanes) < 0.7, rng.integers(-2, 3, (lanes, 2)).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_temporal_merge_list_cells_match_reference(k):
    import jax.numpy as jnp

    from kvazzup_tpu.encoder.frame_inter32 import _merge_list_cells

    rng = np.random.default_rng(10 + k)
    lanes = 512
    pairs = _pairs(rng, 6, lanes)
    names = ("a1", "b1", "b0", "a0", "b2")
    want = _merge_list_cells({n: (jnp.asarray(a), jnp.asarray(m))
                              for n, (a, m) in zip(names, pairs)}, k,
                             temporal=(jnp.asarray(pairs[5][0]), jnp.asarray(pairs[5][1])))
    got = frame_inter32.merge_list_cells({n: (T(a), T(m)) for n, (a, m) in zip(names, pairs)},
                                         k, temporal=(T(pairs[5][0]), T(pairs[5][1])))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_temporal_amvp_lists_match_reference():
    import jax
    import jax.numpy as jnp

    from kvazzup_tpu.encoder.frame_inter import _amvp_list_t
    from kvazzup_tpu.encoder.frame_inter32 import _amvp_cells

    rng = np.random.default_rng(7)
    lanes = 512
    pairs = _pairs(rng, 6, lanes)

    def j(ps):
        return [(jnp.asarray(a), jnp.asarray(m)) for a, m in ps]

    def t(ps):
        return [(T(a), T(m)) for a, m in ps]

    want = _amvp_cells(j(pairs[:2]), j(pairs[2:5]), temporal=j(pairs[5:])[0])
    got = frame_inter32.amvp_cells(t(pairs[:2]), t(pairs[2:5]), temporal=t(pairs[5:])[0])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    flat = [x for a, m in pairs[:2] + pairs[5:] for x in (a, m)]
    want = jax.vmap(_amvp_list_t)(*(jnp.asarray(x) for x in flat))
    got = frame_inter.amvp_list_t(*(T(x) for x in flat))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_production_combo_on_gpu_equals_cpu():
    """The production combo through `Encoder` on cuda: the hand kernels'
    streams and recon equal the port's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc")
    frames = synthetic_frames(W, H, NF, seed=5)
    cs, cr, _ = _port_encode(_cfg(PROD), frames)
    gs, gr, _ = _port_encode(_cfg(PROD), frames, device="cuda")
    assert gs == cs
    for a, b in zip(cr, gr):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
