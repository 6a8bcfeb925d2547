"""1080p bench of the PyTorch port on one NVIDIA card: the lanes of
`bench.py` that the port runs, under bench.py's key names.

    python tools/torch_bench.py [--budget 840] [--seed 12]

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

A device lane's rate is frames over the summed device-stage time (host
clock around `encode_frame_device`, ending in `torch.cuda.synchronize()`);
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
from kvazzup_tpu_torch.encoder.pipelined import PipelinedEncoder  # noqa: E402
from kvazzup_tpu_torch.encoder.top import Encoder  # noqa: E402
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames  # noqa: E402

W, H, QP = 1920, 1080, 32


class Bench:
    """The result dict, emitted once: at the end, by the watchdog at the
    budget, or from a signal handler."""

    def __init__(self, budget_s: float) -> None:
        self.t0 = time.time()
        self.budget_s = budget_s
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
        """True if the lane fits the remaining budget (30 s kept for emit)."""
        left = self.budget_s - (time.time() - self.t0)
        if left > est_s + 30:
            print(f"[bench] lane {name} (t+{time.time() - self.t0:.0f} s)", file=sys.stderr)
            return True
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=840.0, help="seconds before a partial emit")
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    b = Bench(args.budget)
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
