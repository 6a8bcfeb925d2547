"""Write the JAX reference's stream digests for the PyTorch port's chip check.

Encodes `kvazzup_tpu.io.yuv.synthetic_frames(W, H, N, seed)` with the JAX
`Encoder` at the CLI's default low-delay configuration (CTB16, deblocking
on, merge 1, intra period 64), with `--sao` at the CLI's `--sao`
configuration (SAO on, which at CTB16 turns WPP on), with `--ctu 64` at
the CLI's CTB64 quadtree configuration (min CU 8, max TU 32), and with
`--merge`, `--wpp`, `--tmvp` and `--rdoq` as the JAX CLI builds them, and records, per
frame, the SHA-256 and byte length of the Annex-B output plus a SHA-256 of
the reconstruction.  `chip_smoke.py` encodes the same frames with
`kvazzup_tpu_torch` on the GPU and compares against these files.

Runs on the CPU (JAX only; the port's package is not imported):

    python tools/torch_golden.py            # 1920x1080, 4 frames, QP 32
    python tools/torch_golden.py --sao      # the same with SAO + WPP
    python tools/torch_golden.py --ctu 64 --sao   # CTB64 quadtree with SAO
    python tools/torch_golden.py --ctu 64 --wpp --sao --merge 5 --tmvp \
        --out kvazzup_tpu_torch/golden/ld64_prod_1080p_q32.json
    python tools/torch_golden.py --merge 5 --tmvp \
        --out kvazzup_tpu_torch/golden/ld_tmvp_1080p_q32.json
    python tools/torch_golden.py --rdoq --out kvazzup_tpu_torch/golden/ld_rdoq_1080p_q32.json
    python tools/torch_golden.py --ctu 64 --wpp --sao --merge 5 --tmvp --rdoq \
        --out kvazzup_tpu_torch/golden/ld64_prod_rdoq_1080p_q32.json
    python tools/torch_golden.py --width 96 --height 64 --out /tmp/g.json

With `--gop ra` (CTB64 only) the frames go through the JAX CLI's random-access
encoder instead, `QuadRAEncoder` with gop 8 and the intra period rounded down
to a multiple of 8, and the digests are per picture in decode order, each
with its POC:

    python tools/torch_golden.py --gop ra --ctu 64 --wpp --sao --merge 5 --tmvp --rdoq \
        --frames 9 --out kvazzup_tpu_torch/golden/ra64_prod_rdoq_1080p_q32.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cpu_env  # noqa: E402,F401  (selects the JAX CPU backend)

import numpy as np  # noqa: E402

from kvazzup_tpu.core.params import StreamConfig  # noqa: E402
from kvazzup_tpu.encoder.top import Encoder  # noqa: E402
from kvazzup_tpu.io.yuv import synthetic_frames  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "kvazzup_tpu_torch", "golden")


def recon_digest(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(np.asarray(p, np.uint8)).tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--merge", type=int, default=1)
    ap.add_argument("--intra-period", type=int, default=64)
    ap.add_argument("--sao", action="store_true",
                    help="SAO on (and WPP, as the JAX CLI sets it at CTB16)")
    ap.add_argument("--ctu", type=int, choices=(16, 64), default=16,
                    help="CTB size: 16, or the 64 quadtree (min CU 8, max TU 32)")
    ap.add_argument("--wpp", action="store_true", help="wavefront entry points")
    ap.add_argument("--tmvp", action="store_true", help="temporal motion vector prediction")
    ap.add_argument("--rdoq", action="store_true", help="rate-distortion optimized quantization")
    ap.add_argument("--gop", choices=("ld", "ra"), default="ld",
                    help="ra: the CTB64 random-access B pyramid (gop 8)")
    ap.add_argument("--out", default=None,
                    help="default: kvazzup_tpu_torch/golden/ld[64][_sao]_1080p_q32.json")
    args = ap.parse_args(argv)
    if args.out is None:
        if args.wpp or args.tmvp or args.rdoq or args.merge != 1 or args.gop == "ra":
            ap.error("--wpp, --tmvp, --rdoq, --merge and --gop ra need --out")
        name = f"ld{'64' if args.ctu == 64 else ''}{'_sao' if args.sao else ''}_1080p_q32.json"
        args.out = os.path.join(GOLDEN_DIR, name)

    quad = args.ctu == 64
    ra = args.gop == "ra"
    if ra and not quad:
        ap.error("--gop ra needs --ctu 64")
    cfg = StreamConfig.for_source(args.width, args.height, qp=args.qp,
                                  merge_cand=args.merge, sao_enabled=args.sao,
                                  wpp=args.wpp or (args.sao and not quad),
                                  temporal_mvp=args.tmvp, rdoq=args.rdoq,
                                  ctb_log2=6 if quad else 4,
                                  min_cb_log2=3 if quad else 4, max_tb_log2=5 if quad else 4,
                                  num_reorder_pics=3 if ra else 0,
                                  max_dec_pic_buffering=6 if ra else 2)
    frames = synthetic_frames(args.width, args.height, args.frames, seed=args.seed)
    out = []
    t0 = time.time()

    def record(stream, recon, **key):
        out.append({**key, "bytes": len(stream),
                    "sha256": hashlib.sha256(stream).hexdigest(),
                    "recon_sha256": recon_digest(recon)})
        print(f"{key}: {len(stream)} bytes ({time.time() - t0:.1f}s)", flush=True)

    if ra:
        from kvazzup_tpu.encoder.ra import QuadRAEncoder

        args.intra_period = max(8, args.intra_period - args.intra_period % 8)
        enc = QuadRAEncoder(cfg, gop_size=8, intra_period=args.intra_period)
        for (y, u, v) in frames:
            for poc, stream, recon in enc.push_frame(y, u, v):
                record(stream, recon, frame=len(out), poc=poc)
        for poc, stream, recon in enc.flush():
            record(stream, recon, frame=len(out), poc=poc)
    else:
        enc = Encoder(cfg, intra_period=args.intra_period)
        for i, (y, u, v) in enumerate(frames):
            t0 = time.time()
            record(*enc.encode_frame(y, u, v), frame=i)
    doc = {
        "source": ("kvazzup_tpu.encoder.ra.QuadRAEncoder gop 8 (JAX, CPU backend), "
                   "pictures in decode order" if ra else
                   "kvazzup_tpu.encoder.top.Encoder (JAX, CPU backend)"),
        "frames_from": "kvazzup_tpu.io.yuv.synthetic_frames",
        "width": args.width, "height": args.height, "n_frames": args.frames,
        "seed": args.seed, "qp": args.qp, "merge_cand": args.merge,
        "intra_period": args.intra_period,
        "config": {"ctb_log2": cfg.ctb_log2, "min_cb_log2": cfg.min_cb_log2,
                   "max_tb_log2": cfg.max_tb_log2, "coded_width": cfg.width,
                   "coded_height": cfg.height, "deblocking": cfg.deblocking_enabled,
                   "sao": cfg.sao_enabled, "wpp": cfg.wpp, "rdoq": cfg.rdoq,
                   "tmvp": cfg.temporal_mvp, "fast_decision": cfg.fast_decision,
                   "gop": args.gop},
        "frames": out,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
