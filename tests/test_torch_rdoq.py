"""The PyTorch port's RDOQ against the JAX package, op and engines.

Op: `kvazzup_tpu_torch.ops.quant.quantize_rdoq` against
`jax.jit(kvazzup_tpu.ops.quant.quantize_rdoq)` at all 52 QPs, 4x4 to 32x32
blocks, intra and inter deadzones, one lambda^2 per row: coefficients up
to |32767| (so |c| Q passes 2^24 and rounds in float32), and rows whose
lambda^2 is set, ulp by ulp, around the value at which one coefficient's
two candidate costs tie.  Tolerance 0.  The float32 rules it pins (the
reference program's `exp2` polynomial, the folded rate constant, the two
fused multiply-adds) are checked one by one too.

Engines: CTB16 `--rdoq` at 96x64 and the production combo with RDOQ
(`--ctu 64 --wpp --sao --merge 5 --tmvp --rdoq`, the RA P anchors'
configuration) at 192x128, IDR + 2 P at QP 30, each encoded once by the
JAX `Encoder` and once by the port (CPU) in module fixtures: the streams
byte-identical, the recons element-identical, RDOQ changes the stream,
the CLI's `--rdoq` writes the JAX stream, and a JAX snapshot taken after
IDR + P1 resumes in the port.  The `cuda` case (the op on the card
against the CPU) imports no JAX:

    python -m pytest tests/test_torch_rdoq.py -m cuda --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch

from kvazzup_tpu_torch.core.tables import QUANT_SCALES
from kvazzup_tpu_torch.encoder.top import Encoder
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames
from kvazzup_tpu_torch.ops import costs, quant

BD = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU encodes here are long chains of small eager ops: one
    intra-op thread runs them several times faster than many, and leaves
    the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_rdoq():
    import jax

    from kvazzup_tpu.ops.quant import quantize_rdoq

    return jax.jit(quantize_rdoq, static_argnames=("log2", "intra", "bd"))


def _tie_rows(rng, log2: int, intra: bool, per_qp: int = 4, ulps: int = 3):
    """(coef (B, K), qp (B,), lam2 (B,)): per QP, `per_qp` target
    coefficients, each in 2 * ulps + 1 rows whose lambda^2 steps ulp by ulp
    across the value that ties the target's deadzone level with a lower
    candidate; the other coefficients of a row are random up to |32767|."""
    k = 1 << (2 * log2)
    dz = 171 if intra else 85
    rows = []
    for qp in range(52):
        per, rem = divmod(qp, 6)
        qbits = 29 - BD + per - log2
        scale = int(QUANT_SCALES[rem])
        step = float(costs.exp2_int(torch.tensor(qbits)))
        lam_unit = scale * scale * 2.0 ** (30 - 2 * BD - 2 * log2)
        found = 0
        while found < per_qp:
            c = int(np.exp(rng.uniform(0, np.log(32767))))
            num = c * scale
            l_dz = (num + (dz << (qbits - 9))) >> qbits
            if l_dz < 1:
                continue
            alt = max(l_dz - (1 if l_dz > 2 or rng.random() < 0.5 else 2), 0)
            r0, r1 = (float(costs.level_rate(torch.tensor(v))) for v in (l_dz, alt))
            lam = ((num - alt * step) ** 2 - (num - l_dz * step) ** 2) / (r0 - r1) / lam_unit
            lam32 = np.float32(lam)
            if not 0 < lam32 < np.float32(1e6):
                continue
            found += 1
            for u in range(-ulps, ulps + 1):
                lv = lam32
                for _ in range(abs(u)):
                    lv = np.nextafter(lv, np.float32(np.inf if u > 0 else -np.inf))
                row = rng.integers(-32767, 32768, k)
                row[: k // 2] = np.round(np.exp(rng.uniform(0, np.log(32767), k // 2)))
                row[0] = c
                rows.append((row * rng.choice([-1, 1], k), qp, lv))
    coef = np.stack([r[0] for r in rows]).astype(np.int32)
    return (coef, np.array([r[1] for r in rows], np.int32),
            np.array([r[2] for r in rows], np.float32))


@pytest.fixture(scope="module")
def ref_rdoq():
    return _ref_rdoq()


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("intra", [True, False])
def test_quantize_rdoq_matches_reference(ref_rdoq, log2, intra):
    import jax.numpy as jnp

    coef, qp, lam2 = _tie_rows(np.random.default_rng(100 * log2 + intra), log2, intra)
    want = np.asarray(ref_rdoq(jnp.asarray(coef), jnp.asarray(qp), log2=log2,
                               lam=jnp.asarray(lam2), intra=intra))
    got = quant.quantize_rdoq(torch.from_numpy(coef), torch.from_numpy(qp), log2,
                              torch.from_numpy(lam2), intra)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the rows hold decisions both ways: RDOQ moved some levels below the
    # deadzone quantizer's, and kept others
    dzq = quant.quantize(torch.from_numpy(coef), torch.from_numpy(qp), log2, intra).numpy()
    assert (want[:, 0] != dzq[:, 0]).any() and (want[:, 0] == dzq[:, 0]).any()


def _rdoq_variant(coef, qp, log2, lam, intra, variant):
    """quantize_rdoq with one float32 rule replaced by another reading of
    the reference's source: `pow2_step` (step = 2^qbits exactly),
    `plain_e` (l * step rounded before the subtraction), `plain_cost`
    (e * e and lamq * rate rounded, then added) or `rate_plus_one`
    (bits_of(l) + 1, two roundings)."""
    q = qp[:, None]
    per, rem = q // 6, q % 6
    qbits = 29 - BD + per - log2
    scale = torch.as_tensor(QUANT_SCALES, dtype=torch.int32)[rem.long()]
    num = coef.abs() * scale
    l_dz = (num + ((171 if intra else 85) << (qbits - 9))) >> qbits
    numf, scalef = num.float(), scale.float()
    step = torch.exp2(qbits.float()) if variant == "pow2_step" else costs.exp2_int(qbits)
    lamq = lam[:, None] * scalef * scalef * 2.0 ** (30 - 2 * BD - 2 * log2)

    def cost(lev):
        lf = lev.float()
        e = numf - lf * step if variant == "plain_e" else costs.fma(-lf, step, numf)
        rate = (torch.where(lev == 0, 0.0, costs.bits_of(lev) + 1.0)
                if variant == "rate_plus_one" else costs.level_rate(lev))
        return e * e + lamq * rate if variant == "plain_cost" else costs.fma(e, e, lamq * rate)

    l1, l2 = (l_dz - 1).clamp(min=0), (l_dz - 2).clamp(min=0)
    best = torch.where(cost(l1) < cost(l_dz), l1, l_dz)
    best = torch.where((l_dz <= 2) & (cost(l2) < cost(best)), l2, best)
    return torch.where(coef < 0, -best, best)


@pytest.mark.parametrize("variant", ["pow2_step", "plain_e", "plain_cost", "rate_plus_one"])
def test_rdoq_float_rule_is_needed(ref_rdoq, variant):
    """Each of the four float32 rules decides levels on near-tie rows: the
    reference disagrees with a version that replaces any one of them."""
    import jax.numpy as jnp

    diff = 0
    for log2 in (3, 5):
        coef, qp, lam2 = _tie_rows(np.random.default_rng(40 + log2), log2, True)
        want = np.asarray(ref_rdoq(jnp.asarray(coef), jnp.asarray(qp), log2=log2,
                                   lam=jnp.asarray(lam2), intra=True))
        args = (torch.from_numpy(coef), torch.from_numpy(qp), log2, torch.from_numpy(lam2))
        np.testing.assert_array_equal(quant.quantize_rdoq(*args, True).numpy(), want)
        diff += int((_rdoq_variant(*args, True, variant).numpy() != want).sum())
    assert diff > 0


def test_quantize_rdoq_per_lane_deadzone():
    """A bool array picks the deadzone per row (the P waves' use_intra)."""
    import jax
    import jax.numpy as jnp

    from kvazzup_tpu.ops.quant import quantize_rdoq

    rng = np.random.default_rng(3)
    coef, qp, lam2 = _tie_rows(rng, 4, True, per_qp=1, ulps=1)
    intra = rng.random(len(qp)) < 0.5
    ref = jax.jit(lambda c, q, lam, i: quantize_rdoq(c, q, 4, lam, i))
    want = np.asarray(ref(jnp.asarray(coef), jnp.asarray(qp), jnp.asarray(lam2),
                          jnp.asarray(intra)))
    got = quant.quantize_rdoq(torch.from_numpy(coef), torch.from_numpy(qp), 4,
                              torch.from_numpy(lam2), torch.from_numpy(intra))
    np.testing.assert_array_equal(got.numpy(), want)


def test_exp2_table_matches_reference_program():
    """exp2 of the integer qbits as the reference's program computes it;
    it differs from 2^k at most k >= 13, which a power of two would miss."""
    import jax
    import jax.numpy as jnp

    k = np.arange(costs.EXP2_MAX + 1, dtype=np.int32)
    want = np.asarray(jax.jit(lambda q: jnp.exp2(q.astype(jnp.float32)))(jnp.asarray(k)))
    got = costs.exp2_int(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (want != np.ldexp(np.float32(1), k)).sum() > 20
    x = np.random.default_rng(0).uniform(-80, 80, 100000).astype(np.float32)
    np.testing.assert_array_equal(costs.exp_f32(x).view(np.int32),
                                  np.asarray(jax.jit(jnp.exp)(jnp.asarray(x))).view(np.int32))


def test_level_rate_matches_reference_program():
    """where(l == 0, 0, 2 log2(l + 1) + 1 + 1) as compiled: one rounding
    of fma(log(l + 1), 2 / ln 2, 2), which is not bits_of(l) + 1."""
    import jax
    import jax.numpy as jnp

    def rate(lv):
        lf = lv.astype(jnp.float32)
        return jnp.where(lv == 0, 0.0, 2.0 * jnp.log2(lf + 1.0) + 1.0 + 1.0)

    lv = np.arange(32768, dtype=np.int32)
    want = np.asarray(jax.jit(rate)(jnp.asarray(lv)))
    got = costs.level_rate(torch.from_numpy(lv)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plus_one = (costs.bits_of(torch.from_numpy(lv)) + 1.0).numpy()
    assert (plus_one[1:] != want[1:]).any()


# ------------------------------------------------------------------ engines

ENGINES = {
    "ctb16 rdoq": (96, 64, dict(rdoq=True)),
    "ctb64 prod rdoq": (192, 128, dict(ctu=64, wpp=True, sao=True, merge=5, tmvp=True,
                                       rdoq=True)),
}
QP, NF = 30, 3


def _cfg(name, **over):
    w, h, kw = ENGINES[name]
    return stream_config(w, h, qp=QP, **{**kw, **over})


def _frames(name):
    w, h, _ = ENGINES[name]
    return synthetic_frames(w, h, NF, seed=5)


@pytest.fixture(scope="module")
def jax_runs():
    """{engine: (streams, recons, snapshot after IDR + P1)}"""
    from kvazzup_tpu.encoder.top import Encoder as JaxEncoder

    res = {}
    for name in ENGINES:
        jenc = JaxEncoder(_cfg(name), intra_period=64)
        js, jr, snap = [], [], None
        for i, f in enumerate(_frames(name)):
            s, r = jenc.encode_frame(*f)
            js.append(s)
            jr.append(r)
            if i == 1:
                snap = jenc.snapshot()
        res[name] = (js, jr, snap)
    return res


def _port_encode(cfg, frames, device="cpu"):
    enc = Encoder(cfg, intra_period=64, device=device)
    out = [enc.encode_frame(*f) for f in frames]
    return [s for s, _ in out], [r for _, r in out]


@pytest.fixture(scope="module")
def port_runs():
    return {name: _port_encode(_cfg(name), _frames(name)) for name in ENGINES}


@pytest.mark.parametrize("name", list(ENGINES))
def test_stream_byte_identical(jax_runs, port_runs, name):
    js, jr, _ = jax_runs[name]
    ts, tr = port_runs[name]
    assert [len(s) for s in ts] == [len(s) for s in js]
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a == b, f"frame {i} differs"
    for i, (a, b) in enumerate(zip(jr, tr)):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(pa), pb, err_msg=f"recon frame {i}")


@pytest.mark.parametrize("name", list(ENGINES))
def test_rdoq_changes_the_stream(port_runs, name):
    """RDOQ chooses levels, not only computes them: the IDR's and P1's
    streams differ from the deadzone quantizer's."""
    ts, _ = port_runs[name]
    off, _ = _port_encode(_cfg(name, rdoq=False), _frames(name)[:2])
    assert ts[0] != off[0] and ts[1] != off[1]


@pytest.mark.parametrize("name", list(ENGINES))
def test_snapshot_resumes(jax_runs, name):
    """A JAX snapshot after IDR + P1 resumes in the port: P2 byte-identical."""
    js, _, snap = jax_runs[name]
    enc = Encoder(_cfg(name), intra_period=64, device="cpu")
    enc.restore(snap, "cpu")
    assert [enc.encode_frame(*f)[0] for f in _frames(name)[2:]] == js[2:]


@pytest.mark.parametrize("name", list(ENGINES))
def test_cli_rdoq(jax_runs, tmp_path, name):
    from kvazzup_tpu.io.yuv import write_yuv420

    from kvazzup_tpu_torch.cli import main

    w, h, kw = ENGINES[name]
    flags = ["--rdoq"] + (["--ctu", "64", "--wpp", "--sao", "--merge", "5", "--tmvp"]
                          if kw.get("ctu") == 64 else [])
    src = tmp_path / "in.yuv"
    write_yuv420(str(src), _frames(name)[:2])
    out = tmp_path / "out.265"
    assert main(["encode", str(src), str(out), "--size", f"{w}x{h}", "--qp", str(QP),
                 *flags, "--device", "cpu"]) == 0
    assert out.read_bytes() == b"".join(jax_runs[name][0][:2])


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_quantize_rdoq_on_gpu_equals_cpu():
    """RDOQ on the card equals the CPU at every QP and block size: no TF32
    and no device-specific rounding reach its float32 decisions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    for log2 in (2, 3, 4, 5):
        coef, qp, lam2 = _tie_rows(np.random.default_rng(log2), log2, log2 % 2 == 0)
        args = (torch.from_numpy(coef), torch.from_numpy(qp), log2, torch.from_numpy(lam2),
                log2 % 2 == 0)
        want = quant.quantize_rdoq(*args)
        got = quant.quantize_rdoq(args[0].cuda(), args[1].cuda(), log2, args[3].cuda(),
                                  args[4])
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
