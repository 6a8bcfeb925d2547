"""Command-line encoder for the PyTorch port (counterpart of the
`encode` command of kvazzup_tpu/cli.py: low-delay CTB16 and CTB64, and
random access at CTB64).

    python -m kvazzup_tpu_torch encode in.y4m out.265 [--qp 32] [--frames N]
        [--size WxH] [--intra-period 64] [--merge 1..5] [--no-deblock]
        [--sao] [--wpp] [--tmvp] [--rdoq] [--ctu 16|64] [--gop ld|ra]
        [--bitrate BPS [--fps 30]] [--device cuda|cpu]

`--sao` turns WPP on as well at CTB16 (the JAX CLI's rule without tiles);
`--ctu 64` is the CTB64 quadtree (CUs 64 down to 8, TUs up to 32), where
WPP is `--wpp` alone.  The JAX package's production configuration is
`--ctu 64 --wpp --sao --merge 5 --tmvp`.  `--rdoq` quantizes by RDOQ;
`--bitrate` picks each frame's QP by the rate controller of
`pipeline.rate_control` (`--qp` is its starting QP), as the JAX CLI does.
`--gop ra --ctu 64` is the random-access B pyramid the JAX CLI runs there:
`QuadRABatchEncoder` with gop 8 and the intra period rounded down to a
multiple of 8, each picture's NAL written in decode order, at `--qp` (as
in the JAX CLI, `--bitrate` drives the low-delay path only).  The JAX
package's production configuration is `--gop ra --ctu 64 --wpp --sao
--merge 5 --tmvp --rdoq`.

Flags of the JAX CLI that select other configurations are accepted only at
their default value; anything else raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys
import time

# flag -> default value; any other value selects an unported path
_UNPORTED = {"tiles": 1, "slices": 1, "tu_intra_depth": 1, "cu8": False, "bitdepth": 8,
             "cutree": 0.0}


def _read_input(path: str, size: str | None, max_frames: int | None):
    from .inputs import read_y4m, read_yuv420

    if path.endswith(".y4m"):
        frames, w, h, _fps = read_y4m(path, max_frames)
        return frames, w, h
    if not size:
        raise SystemExit("raw .yuv input requires --size WxH")
    w, h = (int(t) for t in size.split("x"))
    return read_yuv420(path, w, h, max_frames), w, h


def cmd_encode(args) -> int:
    from .encoder.top import Encoder
    from .inputs import psnr, stream_config

    bad = [k for k, dflt in _UNPORTED.items() if getattr(args, k) != dflt]
    if args.ctu == 32:
        bad.append("ctu 32")
    if args.gop == "ra" and args.ctu != 64:
        bad.append(f"gop ra at --ctu {args.ctu}")
    if bad:
        raise NotImplementedError(
            f"not ported to kvazzup_tpu_torch: --{', --'.join(b.replace('_', '-') for b in bad)}")
    frames, w, h = _read_input(args.input, args.size, args.frames)
    if not frames:
        raise SystemExit("no frames read")
    cfg = stream_config(w, h, qp=args.qp, deblock=not args.no_deblock, merge=args.merge,
                        sao=args.sao, wpp=args.wpp, tmvp=args.tmvp, rdoq=args.rdoq,
                        ctu=args.ctu, gop=args.gop)
    if args.gop == "ra":
        return _encode_ra(args, cfg, frames, w, h)
    rc = None
    if args.bitrate:
        from .pipeline.rate_control import RateController

        rc = RateController(args.bitrate, args.fps, base_qp=args.qp)
    enc = Encoder(cfg, intra_period=args.intra_period, device=args.device)
    t0 = time.time()
    total_psnr = 0.0
    nbytes = 0
    with open(args.output, "wb") as f:
        for i, (y, u, v) in enumerate(frames):
            qp_i = None
            is_idr = i % args.intra_period == 0
            if rc is not None:
                qp_i = rc.frame_qp(is_idr)
            stream, recon = enc.encode_frame(y, u, v, qp=qp_i)
            if rc is not None:
                rc.update(qp_i, len(stream) * 8, is_idr)
            f.write(stream)
            nbytes += len(stream)
            total_psnr += psnr(y, recon[0])
    dt = time.time() - t0
    print(f"encoded {len(frames)} frames {w}x{h} qp{args.qp} on {args.device}: "
          f"{nbytes} bytes, {dt:.2f}s ({len(frames) / dt:.2f} fps), "
          f"mean PSNR-Y {total_psnr / len(frames):.2f} dB")
    return 0


def _encode_ra(args, cfg, frames, w: int, h: int) -> int:
    from .encoder.ra_batch import QuadRABatchEncoder
    from .inputs import psnr

    ip = max(8, args.intra_period - args.intra_period % 8)
    enc = QuadRABatchEncoder(cfg, gop_size=8, intra_period=ip, device=args.device)
    t0 = time.time()
    nbytes, total_psnr = 0, 0.0
    with open(args.output, "wb") as f:
        out = []
        for y, u, v in frames:
            out += enc.push_frame(y, u, v)
        out += enc.flush()
        for poc, nal, recon in out:
            f.write(nal)
            nbytes += len(nal)
            total_psnr += psnr(frames[poc][0], recon[0])
    dt = time.time() - t0
    print(f"encoded {len(frames)} frames {w}x{h} qp{args.qp} (RA gop 8) on {args.device}: "
          f"{nbytes} bytes, {dt:.2f}s ({len(frames) / dt:.2f} fps), "
          f"mean PSNR-Y {total_psnr / len(frames):.2f} dB")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kvazzup_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("encode")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--qp", type=int, default=32)
    pe.add_argument("--bitrate", type=int, default=0,
                    help="target bits/s: per-frame QP from the rate controller (0: fixed QP)")
    pe.add_argument("--fps", type=float, default=30.0, help="frame rate for --bitrate")
    pe.add_argument("--size", help="WxH for raw .yuv input")
    pe.add_argument("--frames", type=int, default=None)
    pe.add_argument("--intra-period", type=int, default=64)
    pe.add_argument("--merge", type=int, choices=(1, 2, 3, 4, 5), default=1)
    pe.add_argument("--no-deblock", action="store_true")
    pe.add_argument("--sao", action="store_true", help="sample adaptive offset (and WPP)")
    pe.add_argument("--wpp", action="store_true", help="wavefront parallel entry points")
    pe.add_argument("--tmvp", action="store_true", help="temporal motion vector prediction")
    pe.add_argument("--rdoq", action="store_true", help="rate-distortion optimized quantization")
    pe.add_argument("--device", default="cuda", help="torch device (default cuda)")
    # JAX-CLI flags whose non-default values select unported paths
    pe.add_argument("--tiles", type=int, default=1)
    pe.add_argument("--slices", type=int, default=1)
    pe.add_argument("--ctu", type=int, choices=(16, 32, 64), default=16)
    pe.add_argument("--tu-intra-depth", type=int, choices=(1, 2), default=1)
    pe.add_argument("--cu8", action="store_true")
    pe.add_argument("--bitdepth", type=int, choices=(8, 10), default=8)
    pe.add_argument("--gop", choices=["ld", "ra"], default="ld",
                    help="ra: the random-access B pyramid (--ctu 64)")
    pe.add_argument("--cutree", type=float, default=0.0)
    pe.set_defaults(fn=cmd_encode)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
