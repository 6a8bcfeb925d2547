"""The PyTorch port's CTB64 random access against the JAX package.

One JAX `QuadRAEncoder` encode in a module fixture: 192x128 (3 x 2 CTBs,
two lanes a wave), `synthetic_frames(192, 128, 27, seed=7)` at QP 30 with
the production combo and RDOQ (`--gop ra --ctu 64 --wpp --sao --merge 5
--tmvp --rdoq`), gop 8, intra period 24.  It holds the IDR, P8 against a
zero collocated store, P16 against P8's, B pictures at every layer, the
open-GOP I anchor at POC 24 and two flush-tail P pictures.  The port's
`QuadRAEncoder` and `QuadRABatchEncoder` on the CPU each match it picture
by picture (stream bytes, recon elements; tolerance 0), and their B
pictures code bi-prediction, L1-only prediction and a combined merge
candidate.  libavcodec (`tools/hevcref`) decodes the port's stream to its
recons.  The CLI's `--gop ra --ctu 64` writes the JAX bytes, and the
unported RA options raise.  The `cuda` case (the port on the card against
the CPU) imports no JAX:

    python -m pytest tests/test_torch_ra.py -m cuda --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch

from kvazzup_tpu_torch.encoder.frame_b64 import quad_b64_trees_from_device, quad_b_cell_maps
from kvazzup_tpu_torch.encoder.frame_inter32 import walk_p_leaves
from kvazzup_tpu_torch.encoder.ra import QuadRAEncoder
from kvazzup_tpu_torch.encoder.ra_batch import QuadRABatchEncoder
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames

W, H, NF, QP, IP = 192, 128, 27, 30, 24
PROD = dict(ctu=64, wpp=True, sao=True, merge=5, tmvp=True, rdoq=True, gop="ra")
KNOBS = ("KVZ_TPU_RA_BLAM", "KVZ_TPU_RA_DQP", "KVZ_TPU_RA_CUTREE")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU encodes are long chains of small eager ops: one
    intra-op thread runs them several times faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return stream_config(W, H, qp=QP, **PROD)


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(W, H, NF, seed=7)


def _drive(enc, frames):
    out = []
    for f in frames:
        out += enc.push_frame(*f)
    return out + enc.flush()


@pytest.fixture(scope="module")
def jax_ra(frames):
    """[(poc, stream, recon)] of the JAX QuadRAEncoder, in decode order."""
    from kvazzup_tpu.core.params import StreamConfig
    from kvazzup_tpu.encoder.ra import QuadRAEncoder as JaxRA

    # the configuration the JAX CLI builds for --gop ra --ctu 64 and the combo
    cfg = StreamConfig.for_source(W, H, qp=QP, ctb_log2=6, sao_enabled=True, wpp=True,
                                  min_cb_log2=3, max_tb_log2=5, num_reorder_pics=3,
                                  max_dec_pic_buffering=6, merge_cand=5, temporal_mvp=True,
                                  rdoq=True)
    with pytest.MonkeyPatch.context() as mp:
        for k in KNOBS:
            mp.delenv(k, raising=False)
        return [(p, s, tuple(np.asarray(x) for x in r))
                for p, s, r in _drive(JaxRA(cfg, gop_size=8, intra_period=IP), frames)]


@pytest.fixture(scope="module")
def port_ra(frames):
    """{"seq" | "batch": ([(poc, stream, recon)], {poc: B trees})} of the
    port on the CPU."""
    res = {}
    real = QuadRAEncoder._finish_b
    for name, cls in (("seq", QuadRAEncoder), ("batch", QuadRABatchEncoder)):
        trees = {}

        def finish_b(self, planes, out, poc, *args, trees=trees):
            trees[poc] = quad_b64_trees_from_device(out, W, H)
            return real(self, planes, out, poc, *args)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(QuadRAEncoder, "_finish_b", finish_b)
            out = _drive(cls(_cfg(), gop_size=8, intra_period=IP, device="cpu"), frames)
        assert sorted(trees) == [p for p in range(1, 24) if p % 8]
        res[name] = (out, trees)
    return res


def test_schedule_covers_the_ra_cases(jax_ra):
    """Decode order: IDR, each group's anchor then its pyramid, the open-GOP
    I anchor at 24, the flush tail."""
    pocs = [p for p, _, _ in jax_ra]
    assert pocs == [0, 8, 4, 2, 1, 3, 6, 5, 7, 16, 12, 10, 9, 11, 14, 13, 15,
                    24, 20, 18, 17, 19, 22, 21, 23, 25, 26]


@pytest.mark.parametrize("name", ["seq", "batch"])
def test_stream_byte_identical(jax_ra, port_ra, name):
    out, _ = port_ra[name]
    assert [p for p, _, _ in out] == [p for p, _, _ in jax_ra]
    for (poc, js, jr), (_, ts, tr) in zip(jax_ra, out):
        assert ts == js, f"POC {poc}: {len(ts)} bytes against {len(js)}"
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a, b, err_msg=f"recon POC {poc}")


@pytest.mark.parametrize("name", ["seq", "batch"])
def test_b_pictures_code_bi_l1_and_combined(port_ra, name):
    """Coded B leaves use both lists, L1 alone, and a combined merge
    candidate: a merge leaf whose bi-predictive motion is none of its
    spatial neighbours' and not the zero fill."""
    _, trees = port_ra[name]
    n_bi = n_l1 = n_comb = 0
    for tr in trees.values():
        mv4, pf4, _ = quad_b_cell_maps(tr, W, H)
        for node, x0, y0, n in walk_p_leaves(tr, W, 64):
            if "ctype" not in node:
                continue
            pf, mv = node["pf"], np.asarray(node["mv"])
            n_bi += pf == (1, 1)
            n_l1 += pf == (0, 1)
            if node["ctype"] in (1, 3) and pf == (1, 1) and mv.any():
                nbs = [(x0 - 1, y0 + n - 1), (x0 + n - 1, y0 - 1), (x0 + n, y0 - 1),
                       (x0 - 1, y0 + n), (x0 - 1, y0 - 1)]
                spatial = [(tuple(pf4[y >> 2, x >> 2]), mv4[y >> 2, x >> 2]) for x, y in nbs
                           if 0 <= x < W and 0 <= y < H]
                n_comb += not any(p == (1, 1) and np.array_equal(m, mv) for p, m in spatial)
    assert n_bi > 0 and n_l1 > 0 and n_comb > 0, (n_bi, n_l1, n_comb)


def test_oracle_decodes_port_stream(port_ra, tmp_path):
    from tests.test_e2e_intra import oracle_decode

    out, _ = port_ra["seq"]
    ref, log = oracle_decode(b"".join(s for _, s, _ in out), W, H, tmp_path)
    assert len(ref) == NF, log
    recons = dict((p, r) for p, _, r in out)
    for poc in range(NF):
        for a, b in zip(recons[poc], ref[poc]):
            np.testing.assert_array_equal(a, b, err_msg=f"POC {poc} (libavcodec)")


def test_cli_ra_matches_jax(jax_ra, frames, tmp_path):
    """`--gop ra --ctu 64` over the first 9 frames (IDR and one group)
    writes the JAX encoder's first 9 pictures."""
    from kvazzup_tpu.io.yuv import write_yuv420

    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:9])
    out = tmp_path / "out.265"
    assert main(["encode", str(src), str(out), "--size", f"{W}x{H}", "--qp", str(QP),
                 "--gop", "ra", "--ctu", "64", "--wpp", "--sao", "--merge", "5", "--tmvp",
                 "--rdoq", "--intra-period", str(IP), "--device", "cpu"]) == 0
    assert out.read_bytes() == b"".join(s for _, s, _ in jax_ra[:9])


@pytest.mark.parametrize("argv", [["--gop", "ra", "--ctu", "16"],
                                  ["--gop", "ra", "--ctu", "64", "--cutree", "1"]])
def test_cli_unported_ra_options_raise(frames, tmp_path, argv):
    from kvazzup_tpu.io.yuv import write_yuv420

    from kvazzup_tpu_torch.cli import main

    src = tmp_path / "in.yuv"
    write_yuv420(str(src), frames[:1])
    with pytest.raises(NotImplementedError):
        main(["encode", str(src), str(tmp_path / "o.265"), "--size", f"{W}x{H}", *argv,
              "--device", "cpu"])


@pytest.mark.parametrize("var,value", [("KVZ_TPU_RA_BLAM", "1.2,1,1,1"),
                                       ("KVZ_TPU_RA_DQP", "0,1,2,3"),
                                       ("KVZ_TPU_RA_CUTREE", "0.5")])
def test_ra_knobs_raise(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError):
        QuadRAEncoder(_cfg(), gop_size=8, intra_period=IP, device="cpu")


def test_cutree_argument_raises():
    with pytest.raises(NotImplementedError):
        QuadRABatchEncoder(_cfg(), gop_size=8, intra_period=IP, cutree=0.5, device="cpu")


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_ra_on_gpu_equals_cpu():
    """The first five pictures in decode order (IDR, P8, B4, B2 and B1;
    B2 batched with B6, B1 with B3, B5, B7) through `QuadRABatchEncoder`
    on cuda equal the port on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc")
    frames = synthetic_frames(W, H, 9, seed=7)
    cpu = _drive(QuadRABatchEncoder(_cfg(), gop_size=8, intra_period=IP, device="cpu"), frames)
    gpu = _drive(QuadRABatchEncoder(_cfg(), gop_size=8, intra_period=IP, device="cuda"), frames)
    for (pc, sc, rc), (pg, sg, rg) in list(zip(cpu, gpu))[:5]:
        assert (pg, sg) == (pc, sc)
        for a, b in zip(rc, rg):
            np.testing.assert_array_equal(a, b)
