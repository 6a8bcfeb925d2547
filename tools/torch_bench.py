"""1080p bench of the PyTorch port on one NVIDIA card: the lanes of
`bench.py` that the port runs, under bench.py's key names.

    python tools/torch_bench.py [--budget 840] [--seed 12] [--lanes ra_device_1080p,...]

Lanes (each through the port's `Encoder` or `PipelinedEncoder` on cuda, QP
32, `synthetic_frames` content that differs in every timed frame; the
warm-up frames come from another seed):

  encode_fps_1080p_intra_device     CTB16 all-intra (the headline)
  p_fps_1080p_device                CTB16 low-delay P, merge 1
  p_fps_1080p_merge5_device         CTB16 low-delay P, merge 5
  p_fps_1080p_quad64_device         CTB64 low-delay P, merge 5 + TMVP
  e2e_fps_1080p_pipelined           CTB16 all-intra with WPP, PipelinedEncoder
                                    depth 3, recon left on the card
  e2e_fps_1080p_quad64_production   true 1920x1080 (conformance window),
                                    --ctu 64 --wpp --sao --merge 5 --tmvp, LD,
                                    PipelinedEncoder depth 3, recon on the card
  e2e_fps_1080p_sao_pipelined       CTB16 --sao (the Python CABAC tier),
                                    PipelinedEncoder depth 3
  ra_quad64_gop8_device_fps_1080p   random access at CTB64, the production
                                    combo with --rdoq: 8 frames over the device
                                    time of a gop8's four device calls, the P
                                    anchor (P64 engine), one B picture, a
                                    level of two and a level of four (the B
                                    engine with its batch axis), each the
                                    mean of 3 runs on other frames; bench.py's
                                    traffic: every B at the base QP between
                                    its neighbours, not the gop8's layer QPs
  ra_quad64_b64x4_batch_fps         4 over the level of four's time
  e2e_fps_1080p_ra_quad64           QuadRABatchEncoder over 9 frames (one
                                    gop8 group and a flush-tail P) after a
                                    warm-up IDR + group, wall clock

A device lane's rate is frames over the summed device-stage time (host
clock around `encode_frame_device`, ending in `torch.cuda.synchronize()`;
the RA device lane times the engine calls alone, as bench.py does);
its entropy time is the host clock around `encode_frame_entropy`.  A
pipelined lane first encodes the same frames one stage after the other
(device, then entropy), then through the pipeline, and reports both, with
the caller's time in `push` per frame (the device stage while the other
stages run beside it) and the pipeline's stage seconds.  Every lane
records each frame's stream SHA-256.  One JSON line on stdout, always:
at the end, when the budget runs out (a watchdog thread) or on SIGTERM /
SIGINT; lanes that did not fit the budget are listed in
`bench_lanes_skipped`.  No speed is asserted.  Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from kvazzup_tpu_torch import runtime  # noqa: E402
from kvazzup_tpu_torch.encoder.frame_b64 import encode_frame_b64_fast  # noqa: E402
from kvazzup_tpu_torch.encoder.frame_inter64 import encode_frame_p64_fast  # noqa: E402
from kvazzup_tpu_torch.encoder.pipelined import PipelinedEncoder  # noqa: E402
from kvazzup_tpu_torch.encoder.ra_batch import QuadRABatchEncoder  # noqa: E402
from kvazzup_tpu_torch.encoder.top import Encoder, pad_to_coded  # noqa: E402
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames  # noqa: E402

W, H, QP = 1920, 1080, 32


class Bench:
    """The result dict, emitted once: at the end, by the watchdog at the
    budget, or from a signal handler."""

    def __init__(self, budget_s: float, only=()) -> None:
        self.t0 = time.time()
        self.budget_s = budget_s
        self.only = set(only)  # lane names to run; empty: all
        self.r = {"bench_lanes_skipped": [], "lanes": {}}
        self._emitted = threading.Event()
        self._lock = threading.Lock()

    def emit(self) -> None:
        with self._lock:
            if self._emitted.is_set():
                return
            self._emitted.set()
            self.r["bench_wall_s"] = time.time() - self.t0
            print(json.dumps(self.r), flush=True)

    def watchdog(self) -> None:
        while not self._emitted.is_set():
            left = self.budget_s - (time.time() - self.t0)
            if left <= 0:
                print("[bench] budget exhausted: emitting partial results", file=sys.stderr)
                self.emit()
                os._exit(0)
            time.sleep(min(left, 5.0))

    def on_signal(self, signum, frame) -> None:
        print(f"[bench] signal {signum}: emitting partial results", file=sys.stderr)
        self.emit()
        os._exit(0)

    def lane(self, name: str, est_s: float) -> bool:
        """True if the lane was asked for and fits the remaining budget (30 s
        kept for emit)."""
        left = self.budget_s - (time.time() - self.t0)
        if self.only and name not in self.only:
            print(f"[bench] skip lane {name}: not in --lanes", file=sys.stderr)
        elif left > est_s + 30:
            print(f"[bench] lane {name} (t+{time.time() - self.t0:.0f} s)", file=sys.stderr)
            return True
        else:
            print(f"[bench] skip lane {name}: {left:.0f} s left, {est_s} s estimated",
                  file=sys.stderr)
        self.r["bench_lanes_skipped"].append(name)
        return False


def sha(stream: bytes) -> str:
    return hashlib.sha256(stream).hexdigest()


def sequential(cfg, frames, warm, intra_period: int, skip: int = 0) -> dict:
    """Encode warm on a throwaway encoder (untimed), then frames on a new
    one, one stage after the other; the device and entropy ms of every
    frame after the first `skip`."""
    w = Encoder(cfg, intra_period=intra_period, device="cuda")
    for f in warm:
        w.encode_frame_entropy(w.encode_frame_device(*f))
    torch.cuda.synchronize()
    enc = Encoder(cfg, intra_period=intra_period, device="cuda")
    rows = []
    for f in frames:
        t0 = time.perf_counter()
        ctx = enc.encode_frame_device(*f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream, _ = enc.encode_frame_entropy(ctx, materialize_recon=False)
        t2 = time.perf_counter()
        rows.append({"kind": ctx["kind"], "bytes": len(stream), "sha256": sha(stream),
                     "device_ms": (t1 - t0) * 1e3, "entropy_ms": (t2 - t1) * 1e3})
    rows = rows[skip:]
    dev_s = sum(r["device_ms"] for r in rows) / 1e3
    return {"frames": rows, "device_fps": len(rows) / dev_s,
            "e2e_sequential_fps": len(rows) / (dev_s + sum(r["entropy_ms"] for r in rows) / 1e3)}


def pipelined(cfg, frames, warm, intra_period: int) -> dict:
    """warm through a throwaway pipeline, then frames through a new
    PipelinedEncoder (depth 3, recon on the card): e2e rate, push ms per
    frame, stage seconds and stream SHA-256s."""
    def pipe():
        return PipelinedEncoder(cfg, intra_period=intra_period, depth=3,
                                materialize_recon=False, device="cuda")

    with pipe() as pe:
        for f in warm:
            pe.push(*f)
    torch.cuda.synchronize()
    with pipe() as pe:
        out, push_ms = [], []
        t0 = time.perf_counter()
        for f in frames:
            t1 = time.perf_counter()
            out += pe.push(*f)
            push_ms.append((time.perf_counter() - t1) * 1e3)
        out += pe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage = dict(pe.stage)
    return {"e2e_fps": len(frames) / wall, "wall_s": wall, "push_ms": push_ms,
            "stage": stage, "sha256": [sha(s) for s, _ in out],
            "bytes": [len(s) for s, _ in out]}


# the gop8's B levels: each picture with its neighbours as references
RA_LEVELS = {"b64": (4,), "b64x2": (2, 6), "b64x4": (1, 3, 5, 7)}
RA_REPS = 3  # timed runs of each RA device call (bench.py: 6)


def ra_engine_calls(cfg, planes, layer_qp: bool = False) -> dict:
    """The RA engines' device calls of one gop8 on `planes` (9 pictures'
    coded planes on the card, POC 0..8): the P anchor P8 against POC 0
    (merge 5, TMVP against a zero motion store, RDOQ) and the B levels of
    RA_LEVELS (the B engine, with its batch axis for a level of two or
    four), each B picture between its neighbours (POC distances 1 and -1).
    At the base QP, as bench.py's lane, or with `layer_qp` at the gop8's
    layer QPs (B4 +1, B2 / B6 +3, the odd B +4).  Returns {name: fn}."""
    w, h, qp = cfg.width, cfg.height, cfg.qp
    dev = planes[0][0].device
    n16 = (w // 16) * (h // 16)
    z = torch.zeros((n16, 2), dtype=torch.int32, device=dev)

    def p_anchor():
        return encode_frame_p64_fast(*planes[8], *planes[0], qp, width=w, height=h,
                                     merge_cand=5, tmvp=True, col_mv=z,
                                     col_inter=z[:, 0].contiguous(), rdoq=True)

    def level(pics, dqp):
        def st(off, c):
            return torch.stack([planes[i + off][c] for i in pics])
        return lambda: encode_frame_b64_fast(*(st(o, c) for o in (0, -1, 1) for c in range(3)),
                                             qp + dqp, (1, -1), width=w, height=h,
                                             merge_cand=5, rdoq=True)

    dqp = dict(zip(RA_LEVELS, (1, 3, 4) if layer_qp else (0, 0, 0)))
    return {"p_anchor": p_anchor, **{k: level(p, dqp[k]) for k, p in RA_LEVELS.items()}}


def ra_device(cfg, frames) -> dict:
    """Device ms of a gop8's four device calls (`ra_engine_calls`, base
    QP): one untimed B picture, then each call timed RA_REPS times, run r
    on frames[8 r : 8 r + 9], and averaged."""
    pl = [tuple(torch.as_tensor(p, device="cuda") for p in pad_to_coded(cfg, *f)) for f in frames]
    runs = [ra_engine_calls(cfg, pl[8 * r:8 * r + 9]) for r in range(RA_REPS)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed(runs[0]["b64"])  # first use of the B engine's shapes: not timed
    each = {k: [timed(calls[k]) for calls in runs] for k in runs[0]}
    ms = {k: sum(v) / len(v) for k, v in each.items()}
    return {"device_ms": ms, "device_ms_each": each, "gop8_device_fps": 8e3 / sum(ms.values()),
            "b64x4_batch_fps": 4e3 / ms["b64x4"],
            "level_batch_scaling_x4": 4 * ms["b64"] / ms["b64x4"]}


def ra_e2e(cfg, frames) -> dict:
    """QuadRABatchEncoder over frames[9:] (one group and a flush-tail P)
    after frames[:9] (the IDR and one group) on the same encoder: wall
    clock, each timed picture's device / entropy ms and SHA-256."""
    enc = QuadRABatchEncoder(cfg, gop_size=8, intra_period=64, device="cuda")
    for f in frames[:9]:
        enc.push_frame(*f)
    torch.cuda.synchronize()
    n0 = len(enc.times)
    t0 = time.perf_counter()
    out = []
    for f in frames[9:]:
        out += enc.push_frame(*f)
    out += enc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = {tm["poc"]: tm for tm in enc.times[n0:]}
    return {"e2e_fps": len(out) / wall, "wall_s": wall, "pictures": [
        {**times[poc], "bytes": len(s), "sha256": sha(s)} for poc, s, _ in out]}


def run(b: Bench, seed: int) -> None:
    r = b.r
    cfg16 = stream_config(W, H, qp=QP)
    # the timed frames and a warm-up pair of another content
    frames = synthetic_frames(W, H, 8, seed=seed)
    warm = synthetic_frames(W, H, 2, seed=seed + 1000)

    if b.lane("intra_1080p", 40):
        res = sequential(cfg16, frames, warm[:1], intra_period=1)
        r["encode_fps_1080p_intra_device"] = res["device_fps"]
        r["lanes"]["encode_fps_1080p_intra_device"] = res
    for key, merge, est in (("p_fps_1080p_device", 1, 60),
                            ("p_fps_1080p_merge5_device", 5, 70)):
        if b.lane(key, est):
            cfg = stream_config(W, H, qp=QP, merge=merge)
            res = sequential(cfg, frames[:6], warm, intra_period=64, skip=1)  # 5 P
            r[key] = res["device_fps"]
            r["lanes"][key] = res
    if b.lane("p_quad64_1080p", 150):
        cfg = stream_config(W, H, qp=QP, ctu=64, merge=5, tmvp=True)
        res = sequential(cfg, frames[:4], warm, intra_period=64, skip=1)  # 3 P
        r["p_fps_1080p_quad64_device"] = res["device_fps"]
        r["lanes"]["p_fps_1080p_quad64_device"] = res
    if b.lane("e2e_intra_1080p", 60):
        cfg = stream_config(W, H, qp=QP, wpp=True)
        res = {"sequential": sequential(cfg, frames, warm[:1], intra_period=1),
               "pipelined": pipelined(cfg, frames, warm[:1], intra_period=1)}
        r["e2e_fps_1080p_pipelined"] = res["pipelined"]["e2e_fps"]
        r["lanes"]["e2e_fps_1080p_pipelined"] = res
    if b.lane("e2e_quad64_1080p", 240):
        cfg = stream_config(W, H, qp=QP, ctu=64, wpp=True, sao=True, merge=5, tmvp=True)
        # IDR + 3 P, low delay
        res = {"sequential": sequential(cfg, frames[:4], warm, intra_period=64),
               "pipelined": pipelined(cfg, frames[:4], warm, intra_period=64)}
        r["e2e_fps_1080p_quad64_production"] = res["pipelined"]["e2e_fps"]
        r["lanes"]["e2e_fps_1080p_quad64_production"] = res
    if b.lane("e2e_sao_1080p", 180):
        # the Python CABAC tier holds the interpreter lock: push ms against
        # the sequential device ms shows what it costs the launch loop
        cfg = stream_config(W, H, qp=QP, sao=True)
        res = {"sequential": sequential(cfg, frames[:3], warm, intra_period=64),
               "pipelined": pipelined(cfg, frames[:3], warm, intra_period=64)}
        r["e2e_fps_1080p_sao_pipelined"] = res["pipelined"]["e2e_fps"]
        r["lanes"]["e2e_fps_1080p_sao_pipelined"] = res
    cfg_ra = stream_config(W, H, qp=QP, ctu=64, wpp=True, sao=True, merge=5, tmvp=True,
                           rdoq=True, gop="ra")
    if b.lane("ra_device_1080p", 500):
        res = ra_device(cfg_ra, synthetic_frames(W, H, 8 * RA_REPS + 1, seed=seed))
        r["ra_quad64_gop8_device_fps_1080p"] = res["gop8_device_fps"]
        r["ra_quad64_b64x4_batch_fps"] = res["b64x4_batch_fps"]
        r["lanes"]["ra_quad64_gop8_device_fps_1080p"] = res
    if b.lane("e2e_ra_1080p", 480):
        res = ra_e2e(cfg_ra, synthetic_frames(W, H, 18, seed=seed))
        r["e2e_fps_1080p_ra_quad64"] = res["e2e_fps"]
        r["lanes"]["e2e_fps_1080p_ra_quad64"] = res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=840.0, help="seconds before a partial emit")
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--lanes", default="",
                    help="comma-separated lane names to run (as the [bench] lines name them; "
                         "default: every lane)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    b = Bench(args.budget, [n for n in args.lanes.split(",") if n])
    signal.signal(signal.SIGTERM, b.on_signal)
    signal.signal(signal.SIGINT, b.on_signal)
    threading.Thread(target=b.watchdog, daemon=True).start()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    b.r.update(card=card, device=torch.cuda.get_device_name(0), seed=args.seed,
               torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.time()
    runtime.kernel_lib()  # builds the kernels: not inside a lane
    b.r["kernel_build_s"] = time.time() - t0
    run(b, args.seed)
    b.emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
