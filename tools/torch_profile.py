"""Where the time goes in the PyTorch port's 1080p low-delay encode (GPU).

    python tools/torch_profile.py [--width 1920 --height 1080 --qp 32] [--ctu 16|64]
        [--prod | --ra]

Warms up on a throwaway encoder (IDR + P), then for one IDR and one P
frame of `synthetic_frames(W, H, 3, seed=12)` at CTB 16 (default), the
CTB64 quadtree (`--ctu 64`, with SAO) or the JAX package's production
combo (`--prod`: `--ctu 64 --wpp --sao --merge 5 --tmvp`; its profiled P
frame is the second, the first that reads a motion store):
  * times each stage with the host clock around work that ends in
    torch.cuda.synchronize() (prepasses, the wave loop, deblocking, and
    the `--sao` path's SAO decisions and application on the deblocked IDR
    frame);
  * profiles the whole device stage with torch.profiler, and the SAO stage
    alone, and reports the kernel count, summed kernel time, device busy
    share of the wall time, the top kernels by device time, and the launches
    and device time of each hand-written kernel (`csrc/*.cu`).
With `--ra` it profiles the random-access engines of the production combo
with `--rdoq` instead (`tools/torch_bench.ra_engine_calls` at the gop8's
layer QPs): the P anchor (`encode_frame_p64_fast`, zero motion store),
one B picture and a pyramid level of four B pictures
(`encode_frame_b64_fast` without and with its batch axis), on source
frames as references, after one untimed B picture: the B prepass and
wave-loop times, then each call's device events per wave and busy share.
Needs a CUDA device; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from kvazzup_tpu_torch import runtime  # noqa: E402
from kvazzup_tpu_torch.encoder import frame_inter, frame_intra, frame_intra64  # noqa: E402
from kvazzup_tpu_torch.encoder.wavefront import schedule_r  # noqa: E402
from kvazzup_tpu_torch.encoder.top import Encoder, pad_to_coded  # noqa: E402
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames  # noqa: E402
from kvazzup_tpu_torch.ops import mc  # noqa: E402
from kvazzup_tpu_torch.ops.deblock import deblock_frame  # noqa: E402
from kvazzup_tpu_torch.ops.me import motion_search  # noqa: E402
from kvazzup_tpu_torch.ops.sao import (sao_apply_planes, sao_decide,  # noqa: E402
                                       sao_decide_chroma, sao_lambda)

# the __global__ functions of csrc/*.cu
HAND_KERNELS = ("satd_kernel", "quant_kernel", "dequant_kernel", "code_residual_kernel",
                "sao_apply_kernel", "merge_search_kernel")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_profile(fn):
    """(wall ms, device event count, summed device ms, top events, hand
    kernels' (launches, device ms)) of fn(); device events are kernels and
    copies."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    hand: dict = {}
    for name, (n, t) in by_name.items():
        # demangled or mangled names; "quant_kernel" must not match "dequant_kernel"
        k = next((k for k in HAND_KERNELS if re.search(rf"(?<![a-z_]){k}", name)), None)
        if k:
            c, u = hand.get(k, (0, 0.0))
            hand[k] = (c + n, u + t)
    return (wall, len(kernels), busy, [(k[:70], n, round(t, 3)) for k, (n, t) in top],
            hand)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--ctu", type=int, choices=(16, 64), default=16)
    ap.add_argument("--prod", action="store_true",
                    help="the production combo --ctu 64 --wpp --sao --merge 5 --tmvp")
    ap.add_argument("--ra", action="store_true",
                    help="the RA engines of the production combo with --rdoq: P anchor, B, B x4")
    args = ap.parse_args(argv)
    dev = runtime.require_cuda()
    if args.ra:
        return profile_ra(args, dev)
    if args.ctu == 64 or args.prod:
        return profile_ctb64(args, dev)
    cfg = stream_config(args.width, args.height, qp=args.qp)
    w, h, qp = cfg.width, cfg.height, cfg.qp
    raw = synthetic_frames(args.width, args.height, 3, seed=12)
    warm = Encoder(cfg, intra_period=64, device=dev)
    ref = warm.encode_frame_device(*raw[0])["recon"]
    warm.encode_frame_device(*raw[1])
    y, u, v = (torch.as_tensor(p, device=dev) for p in pad_to_coded(cfg, *raw[2]))
    nctu = cfg.ctbs_w * cfg.ctbs_h
    qp_rows, _, lam_rows, oy, _, _ = frame_intra.frame_setup(y, u, v, qp, nctu)

    stages = {}
    oy_flat = oy.reshape(nctu, -1)
    _, stages["idr_mode_prepass"] = timed(lambda: frame_intra.rd_prepass_grid(
        y, oy_flat, qp_rows, lam_rows, log2=4, cw=cfg.ctbs_w, ch=cfg.ctbs_h))
    out_i, stages["idr_total"] = timed(lambda: frame_intra.encode_frame_intra_fast(
        y, u, v, qp, width=w, height=h))
    stages["idr_wave_loop"] = stages["idr_total"] - stages["idr_mode_prepass"]
    db, stages["deblock_idr"] = timed(lambda: deblock_frame(
        out_i["recon_y"], out_i["recon_u"], out_i["recon_v"], qp))
    lam = sao_lambda(qp)

    def sao_apply_frame(luma, chroma):
        return sao_apply_planes([(db[0], *luma[:3], 16),
                                 (db[1], chroma[0], chroma[2], chroma[4], 8),
                                 (db[2], chroma[0], chroma[3], chroma[5], 8)])

    def sao_stage():
        return sao_apply_frame(sao_decide(y, db[0], lam, ctb=16),
                               sao_decide_chroma(u, db[1], v, db[2], lam, ctb=8))

    timed(sao_stage)  # first use of its kernels in this process: not timed
    luma, stages["sao_decide_luma"] = timed(lambda: sao_decide(y, db[0], lam, ctb=16))
    chroma, stages["sao_decide_chroma"] = timed(lambda: sao_decide_chroma(
        u, db[1], v, db[2], lam, ctb=8))
    _, stages["sao_apply_3_planes"] = timed(lambda: sao_apply_frame(luma, chroma))
    lam_x1k = int(frame_intra.LAMBDA_X1K[qp])
    _, stages["p_motion_search"] = timed(lambda: motion_search(
        y, ref[0], lam_x1k, width=w, height=h))
    _, stages["p_intra_cost_prepass"] = timed(lambda: frame_intra.cost_prepass_grid(
        y, oy_flat, lam_rows, log2=4, cw=cfg.ctbs_w, ch=cfg.ctbs_h))
    _, stages["p_ref_windows"] = timed(lambda: [
        mc.sheared_ref_strips(mc.edge_pad(p, pad), n, 16, cfg.ctbs_h, pad, chroma=n == 8)
        for p, n, pad in ((ref[0], 16, 24), (ref[1], 8, 12), (ref[2], 8, 12))])
    _, stages["p_total"] = timed(lambda: frame_inter.encode_frame_p_fast(
        y, u, v, *ref, qp, width=w, height=h))
    stages["p_wave_loop_and_rest"] = (stages["p_total"] - stages["p_motion_search"]
                                      - stages["p_intra_cost_prepass"] - stages["p_ref_windows"])
    for k, t in stages.items():
        print(f"{k:24s} {t:10.3f} ms", flush=True)

    enc = Encoder(cfg, intra_period=64, device=dev)
    prof = profile_frames(cfg, (("idr", lambda: enc.encode_frame_device(*raw[0])),
                                ("p", lambda: enc.encode_frame_device(*raw[1])),
                                ("sao_stage", sao_stage)))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "stages_ms": stages,
                      "profile": prof}), flush=True)
    return 0


def profile_frames(cfg, runs) -> dict:
    """torch.profiler over each (kind, fn) of runs; prints and returns the
    wall time, device events (also per wave), kernel time, busy share, top
    kernels and hand kernels of each."""
    n_waves = schedule_r(cfg.ctbs_w, cfg.ctbs_h)["n_waves"]
    prof = {}
    for kind, fn in runs:
        wall, n, busy, top, hand = device_profile(fn)
        prof[kind] = {"wall_ms": wall, "kernels": n, "kernels_per_wave": n / n_waves,
                      "kernel_ms": busy, "busy_share": busy / wall, "top": top,
                      "hand_kernels": hand}
        print(f"{kind}: wall {wall:.1f} ms, {n} kernels ({n / n_waves:.1f} per wave of "
              f"{n_waves}), kernel time {busy:.1f} ms, busy {100 * busy / wall:.1f}%",
              flush=True)
        for name, cnt, t in top:
            print(f"   {t:9.3f} ms {cnt:7d}x  {name}", flush=True)
        for name, (cnt, t) in sorted(hand.items()):
            print(f"   hand kernel {name}: {cnt} launches, {t:.4f} ms device, "
                  f"{t / cnt:.5f} ms each", flush=True)
    return prof


def profile_ctb64(args, dev) -> int:
    """The CTB64 quadtree path with SAO (and with `--prod` WPP, merge 5 and
    TMVP): prepass, wave loop, deblocking and SAO stage times of an IDR and
    a P frame, then the profiler's view of each frame's device stage."""
    from kvazzup_tpu_torch.encoder import frame_inter64

    prod = dict(wpp=True, merge=5, tmvp=True) if args.prod else {}
    cfg = stream_config(args.width, args.height, qp=args.qp, sao=True, ctu=64, **prod)
    w, h, qp = cfg.width, cfg.height, cfg.qp
    nctb = cfg.ctbs_w * cfg.ctbs_h
    cw, ch = cfg.ctbs_w, cfg.ctbs_h
    raw = synthetic_frames(args.width, args.height, 3, seed=12)
    warm = Encoder(cfg, intra_period=64, device=dev)
    ref = warm.encode_frame_device(*raw[0])["recon"]
    warm.encode_frame_device(*raw[1])
    y, u, v = (torch.as_tensor(p, device=dev) for p in pad_to_coded(cfg, *raw[2]))
    yi = y.to(torch.int32)
    qp16, _, lam16 = frame_intra64.frame_rows(qp, 16 * nctb, dev)
    qp32, _, lam32 = frame_intra64.frame_rows(qp, 4 * nctb, dev)
    qp64, _, lam64 = frame_intra64.frame_rows(qp, nctb, dev)
    oy16 = frame_intra.to_blocks(yi, 16).reshape(-1, 256)
    oy32 = frame_intra.to_blocks(yi, 32).reshape(-1, 1024)

    def idr_prepass():
        frame_intra.rd_prepass_grid(yi, oy16, qp16, lam16, log2=4, cw=4 * cw, ch=4 * ch)
        sweep = frame_intra.mode_sweep(yi, oy32, lam32, 2 * cw, 2 * ch, None, 5)
        frame_intra.rd_prepass_grid(yi, oy32, qp32, lam32, log2=5, cw=2 * cw, ch=2 * ch,
                                    sweep=sweep)
        frame_intra64.rd64_prepass(sweep, oy32, qp64, lam64, cw64=cw, ch64=ch)

    stages = {}
    _, stages["idr64_prepasses"] = timed(idr_prepass)
    _, stages["idr64_total"] = timed(lambda: frame_intra64.encode_frame_intra64_fast(
        y, u, v, qp, width=w, height=h))
    stages["idr64_wave_loop_and_rest"] = stages["idr64_total"] - stages["idr64_prepasses"]
    enc = Encoder(cfg, intra_period=64, device=dev)
    ctx, stages["idr64_device_stage"] = timed(lambda: enc.encode_frame_device(*raw[2]))
    lam_x1k = int(frame_intra.LAMBDA_X1K[qp])
    _, stages["p64_motion_search_64_32_16"] = timed(lambda: [motion_search(
        y, ref[0], lam_x1k, block=b, width=w, height=h) for b in (64, 32, 16)])
    _, stages["p64_intra_estimates_32_16"] = timed(lambda: [
        frame_intra.cost_prepass_grid(yi, oy32, lam32, log2=5, cw=2 * cw, ch=2 * ch),
        frame_intra.cost_prepass_grid(yi, oy16, lam16, log2=4, cw=4 * cw, ch=4 * ch)])
    _, stages["p64_total"] = timed(lambda: frame_inter64.encode_frame_p64_fast(
        y, u, v, *ref, qp, width=w, height=h, merge_cand=cfg.merge_cand,
        tmvp=cfg.temporal_mvp))
    stages["p64_wave_loop_and_rest"] = (stages["p64_total"]
                                        - stages["p64_motion_search_64_32_16"]
                                        - stages["p64_intra_estimates_32_16"])
    _, stages["p64_device_stage"] = timed(lambda: enc.encode_frame_device(*raw[1]))
    db = ctx["recon"]
    lam = sao_lambda(qp)
    _, stages["sao_decide_luma_ctb64"] = timed(lambda: sao_decide(y, db[0], lam, ctb=64))
    _, stages["sao_decide_chroma_ctb32"] = timed(lambda: sao_decide_chroma(
        u, db[1], v, db[2], lam, ctb=32))
    for k, t in stages.items():
        print(f"{k:28s} {t:10.3f} ms", flush=True)

    enc = Encoder(cfg, intra_period=64, device=dev)
    prof = profile_frames(cfg, (("idr64", lambda: enc.encode_frame_device(*raw[0])),))
    if cfg.temporal_mvp:  # the first P frame fills the motion store, unprofiled
        enc.encode_frame_device(*raw[1])
    prof.update(profile_frames(cfg, (("p64", lambda: enc.encode_frame_device(
        *raw[2 if cfg.temporal_mvp else 1])),)))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "ctu": 64, "prod": args.prod,
                      "stages_ms": stages, "profile": prof}), flush=True)
    return 0


def profile_ra(args, dev) -> int:
    """The RA engines at the production combo with RDOQ: the B prepass and
    wave-loop times of one picture and of a level of four, then the
    profiler's view of a P anchor, a B picture and a B level."""
    from kvazzup_tpu_torch.encoder import frame_b64
    from torch_bench import ra_engine_calls

    cfg = stream_config(args.width, args.height, qp=args.qp, ctu=64, wpp=True, sao=True,
                        merge=5, tmvp=True, rdoq=True, gop="ra")
    w, h, qp = cfg.width, cfg.height, cfg.qp
    pl = [tuple(torch.as_tensor(p, device=dev) for p in pad_to_coded(cfg, *f))
          for f in synthetic_frames(args.width, args.height, 9, seed=12)]
    calls = ra_engine_calls(cfg, pl, layer_qp=True)
    p_anchor, b_one, b_four = calls["p_anchor"], calls["b64"], calls["b64x4"]

    timed(b_one)  # first use of the B engine's shapes in this process: not timed
    stages = {}
    _, stages["b64_prepass"] = timed(lambda: frame_b64._prepass(
        *pl[4], ((*pl[3],), (*pl[5],)), qp + 1, w, h))
    _, stages["b64_total"] = timed(b_one)
    _, stages["b64x4_total"] = timed(b_four)
    stages["b64_wave_loop_and_rest"] = stages["b64_total"] - stages["b64_prepass"]
    stages["b64x4_wave_loop_and_rest"] = stages["b64x4_total"] - 4 * stages["b64_prepass"]
    _, stages["p64_anchor_total"] = timed(p_anchor)
    for k, t in stages.items():
        print(f"{k:28s} {t:10.3f} ms", flush=True)
    prof = profile_frames(cfg, (("p64_anchor", p_anchor), ("b64", b_one), ("b64x4", b_four)))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "ra": True, "stages_ms": stages,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "profile": prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
