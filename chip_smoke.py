"""GPU smoke check of the PyTorch port (kvazzup_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi), then the CUDA kernel build
     (one nvcc per source, in parallel);
  2. each hand kernel (SATD, quant, dequant, the fused residual coding, SAO
     apply, the P wave's merge search) against its plain PyTorch version on
     the card at the 1080p main-path shapes of the CTB16 and CTB64 paths
     and of the CTB64 B path (SATD at the B prepass's L0 / L1 / BI rows
     and the B arbitration's 5 + 3 candidate sets, one picture and levels
     of two and four; dequant at the RDOQ route's shapes of those levels;
     SATD also at 4x4, 8x8, 32x32 and 64x64 blocks; quant and dequant at
     the CTB64 path's 32x32 transform shapes; dequant at the RDOQ route's
     stacked chroma shapes; SATD at the CTB64 wave's
     arbitration shapes with 1 and 5 merge candidates; the residual kernel
     over a CU32's two 16x16 chroma blocks (512 threads); the merge search
     at 1, 3 and 5 candidates with MVs that leave the window and tied
     costs; SAO over three planes in one launch at CTB 16 and 64, one plane
     at a time, and at bit depths 8 and 10 on planes that are no CTB
     multiple (1080x1920 at CTB 64, 540x960 at CTB 32)), element-identical
     (tolerance 0; float32 outputs bit for bit), plus first-index
     tie-breaking of argmin, stable sort and its top-k, and RDOQ
     (`quant.quantize_rdoq`, plain PyTorch) on the card equal to the CPU at
     all 52 QPs and 4x4 to 32x32 blocks;
  3. seven 1920x1080 encodes of synthetic_frames(1920, 1080, 4, seed=12)
     at QP 32 through `Encoder` on cuda, IDR + 3 P (`--sao` and `--ctu 64
     --sao` IDR + P, the production combo with and without `--rdoq` IDR +
     2 P: prefixes of their goldens): the CLI defaults,
     `--sao` (SAO + WPP), `--ctu 64 --sao` (the CTB64 quadtree with SAO),
     the JAX package's production combo `--ctu 64 --wpp --sao --merge 5
     --tmvp`, CTB16 `--merge 5 --tmvp`, and `--rdoq` at CTB16 and with the
     production combo.  Each is held against its JAX golden
     (kvazzup_tpu_torch/golden/ld_1080p_q32.json, ld_sao_1080p_q32.json,
     ld64_sao_1080p_q32.json, ld64_prod_1080p_q32.json,
     ld_tmvp_1080p_q32.json, ld_rdoq_1080p_q32.json,
     ld64_prod_rdoq_1080p_q32.json): per-frame bytes, stream SHA-256 and
     recon SHA-256; each prints its per-frame device and entropy times and
     the launch count of every kernel, counted from 0 over that encode
     alone; every kernel the path runs must launch, exactly as often as its
     code launches it (`expected_launches`);
  4. `PipelinedEncoder` (depth 3) over every frame of ld_1080p_q32.json and
     the first two of ld64_prod_1080p_q32.json, each frame held against the
     golden, launches as counted; prints the e2e frame rate and the stage
     seconds beside phase 3's sequential times of the same frames;
  RA. random access at CTB64: synthetic_frames(1920, 1080, 9, seed=12) at
     QP 32 with `--gop ra --ctu 64 --wpp --sao --merge 5 --tmvp --rdoq`,
     intra period 64 (an IDR and one gop8 group: P8, B4, {B2, B6} and {B1,
     B3, B5, B7}, each level in one batched device call) through
     `QuadRABatchEncoder` on cuda, every picture held against
     kvazzup_tpu_torch/golden/ra64_prod_rdoq_1080p_q32.json in decode
     order (POC, bytes, SHA-256, recon SHA-256); prints each picture's
     device and entropy ms, the launches of every kernel (counted from the
     code, `expected_launches`) and the peak device memory;
  5. kernel vs plain times at the main-path shapes (CUDA events around 20
     calls, the least of 5 runs: at the wave shapes this is the wrapper's
     host path per call), the kernel's own device time per call
     (torch.profiler, mean of 20 calls), beside each kernel's bound (bytes
     moved over 3.35 TB/s, operations over 67 Tops/s, the larger; every
     input read once, every output written once).
The next-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kvazzup_tpu_torch import runtime
from kvazzup_tpu_torch.encoder.pipelined import PipelinedEncoder
from kvazzup_tpu_torch.encoder.ra_batch import QuadRABatchEncoder
from kvazzup_tpu_torch.encoder.top import Encoder
from kvazzup_tpu_torch.encoder.wavefront import schedule_r
from kvazzup_tpu_torch.inputs import stream_config, synthetic_frames
from kvazzup_tpu_torch.ops import hopper_q, merge, quant, sao
from kvazzup_tpu_torch.ops.mc import sheared_ref_strips, strip_window_slice

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "kvazzup_tpu_torch", "golden")
# phase 3: (configuration, golden, frames encoded: a prefix of the golden's).
# The CTB16 --sao path (the Python CABAC tier) and CTB64 --sao (the kernels
# and launch rules of the production combo) are cut in depth to keep the
# script inside its time limit.  Both production paths keep a P that reads
# a P's motion store (the RA phase's P anchor reads an I picture's only).
PATHS = (("low-delay", "ld_1080p_q32.json", 4), ("low-delay --sao", "ld_sao_1080p_q32.json", 2),
         ("low-delay --ctu 64 --sao", "ld64_sao_1080p_q32.json", 2),
         ("low-delay --ctu 64 --wpp --sao --merge 5 --tmvp", "ld64_prod_1080p_q32.json", 3),
         ("low-delay --merge 5 --tmvp", "ld_tmvp_1080p_q32.json", 4),
         ("low-delay --rdoq", "ld_rdoq_1080p_q32.json", 4),
         ("low-delay --ctu 64 --wpp --sao --merge 5 --tmvp --rdoq",
          "ld64_prod_rdoq_1080p_q32.json", 3))
RA_GOLDEN = "ra64_prod_rdoq_1080p_q32.json"
# the RA phase's device calls: the IDR, P8, B4, then the levels {B2, B6} and
# {B1, B3, B5, B7} (QuadRABatchEncoder._LEVELS)
RA_CALLS = ("quad", "quad_p", "quad_b1", "quad_b2", "quad_b4")
# phase 4: (golden, frames) through PipelinedEncoder
PIPELINED = (("ld_1080p_q32.json", 4), ("ld64_prod_1080p_q32.json", 2))
SOURCE = {"satd": "kvazzup_tpu_torch/csrc/q_kernels.cu",
          "quant": "kvazzup_tpu_torch/csrc/q_kernels.cu",
          "dequant": "kvazzup_tpu_torch/csrc/q_kernels.cu",
          "residual": "kvazzup_tpu_torch/csrc/resid_kernels.cu",
          "sao": "kvazzup_tpu_torch/csrc/sao_kernels.cu",
          "merge": "kvazzup_tpu_torch/csrc/merge_kernels.cu"}
REPLACES = {"satd": "kvazzup_tpu/ops/pallas_q.py:85",
            "quant": "kvazzup_tpu/ops/pallas_q.py:56",
            "dequant": "kvazzup_tpu/ops/pallas_q.py:70",
            # fuses the quant (:56) and dequant (:70) kernels with the transforms
            "residual": "kvazzup_tpu/ops/pallas_q.py:56",
            "sao": "kvazzup_tpu/ops/sao.py:185",
            # fuses the SATD kernel (:85) with the merge block's luma MC, cost
            # and argmin (kvazzup_tpu/encoder/frame_inter.py:471-490)
            "merge": "kvazzup_tpu/ops/pallas_q.py:85"}
KERNELS = tuple(REPLACES)
# each kernel's __global__ function, as the profiler names it
KERNEL_FN = {"satd": "satd_kernel", "quant": "quant_kernel", "dequant": "dequant_kernel",
             "residual": "code_residual_kernel", "sao": "sao_apply_kernel",
             "merge": "merge_search_kernel"}
NCTU, LANES = 8160, 68  # 1920x1088 at CTB16: 120 x 68 CTUs, 68 lanes per wave
NCTB64, LANES64 = 510, 17  # 1920x1088 at CTB64: 30 x 17 CTBs, 17 lanes per wave
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# integer and float32 arithmetic outside the tensor cores: the card's float32
# peak; its int32 rate is no higher, so the time bound stays a lower bound
OPS_PER_S = 67e12
# arithmetic operations per element of the first operand (per output sample
# for SAO), counted from each kernel's source; for the residual kernel per
# sample of a block of N x N by log2 N: four transform stages of N
# multiply-adds (8 N) and 43 more (the residual, 4 rounding shifts, quant 16,
# dequant 11, 4 clips, the recon); for the merge search per candidate and
# lane: 23 x 16 horizontal sums of 8 multiply-adds, 256 vertical ones, 4
# per sample for the shift, rounding and clip, the SATD's 9 per sample
OPS_PER_ELEM = {"satd": 9, "quant": 7, "dequant": 5, "sao": 12,
                "residual": {3: 8 * 8 + 43, 4: 8 * 16 + 43},
                "merge": 23 * 16 * 16 + 256 * 16 + 256 * 4 + 256 * 9}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """ms per call of fn, CUDA events around `iters` calls: the least of
    `reps` such runs, so that a pause of the host in one run does not count."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms(name: str, fn, iters: int = 20):
    """The device time per call of fn's hand kernel: the profiler's CUDA
    events of its __global__ function over `iters` calls, summed, over
    `iters`; None if two traces in a row saw none."""
    # "quant_kernel" must not match "dequant_kernel"
    pat = re.compile(rf"(?<![a-z_]){KERNEL_FN[name]}")
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a short trace has come back without its kernels: once more
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and pat.search(e.name)]
        if us:
            return sum(us) / 1e3 / iters
    return None


def launches() -> dict:
    return {**hopper_q.LAUNCHES, **sao.LAUNCHES, **merge.LAUNCHES}


def reset_launches() -> None:
    hopper_q.reset_launches()
    sao.reset_launches()
    merge.reset_launches()


def kernel_cases(dev):
    """(kernel, label, kernel_fn, plain_fn, operands, operations) at the
    1080p main-path shapes; the operands are the inputs the kernel reads,
    the operations its arithmetic on them (OPS_PER_ELEM)."""
    rng = np.random.default_rng(2026)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def qrows(b):
        return t(rng.integers(0, 52, (b,)).astype(np.int32))

    def dzrows(b):
        return t(np.where(rng.integers(0, 2, (b,)) > 0, 171, 85).astype(np.int32))

    cases = []

    def add(name, label, kfn, pfn, operands):
        cases.append((name, label, kfn, pfn, operands,
                      OPS_PER_ELEM[name] * operands[0].numel()))

    # SATD: P-frame ME cost (8160, 256); IDR prepass 35 and P intra prepass
    # 11 predictions against the broadcast original (8160*35, 8160*11 rows);
    # in-wave merge cost (68, 256)
    pix = lambda *s: t(rng.integers(0, 256, s).astype(np.int32))  # noqa: E731
    a, b = pix(NCTU, 256), pix(NCTU, 256)
    add("satd", "ME (8160,256)", lambda a=a, b=b: hopper_q.satd_rows(a, b, 4),
        lambda a=a, b=b: hopper_q.satd_rows_plain(a, b, 4), (a, b))
    a35, o = pix(NCTU * 35, 256), pix(NCTU, 256)
    add("satd", "prepass (8160*35,256) bcast",
        lambda: hopper_q.satd_rows(a35, o, 4, group=35),
        lambda: hopper_q.satd_rows_plain(a35, o, 4, group=35), (a35, o))
    a11, o11 = pix(NCTU * 11, 256), pix(NCTU, 256)
    add("satd", "P prepass (8160*11,256) bcast",
        lambda: hopper_q.satd_rows(a11, o11, 4, group=11),
        lambda: hopper_q.satd_rows_plain(a11, o11, 4, group=11), (a11, o11))
    aw, bw = pix(LANES, 256), pix(LANES, 256)
    add("satd", "wave (68,256)", lambda: hopper_q.satd_rows(aw, bw, 4),
        lambda: hopper_q.satd_rows_plain(aw, bw, 4), (aw, bw))
    # the other block sizes over the same frame: 4x4, 8x8 and 32x32 blocks
    for log2, rows in ((2, NCTU * 16), (3, NCTU * 4), (5, NCTU // 4)):
        al, bl = pix(rows, 1 << 2 * log2), pix(rows, 1 << 2 * log2)
        add("satd", f"{1 << log2}x{1 << log2} ({rows},{1 << 2 * log2})",
            lambda al=al, bl=bl, lg=log2: hopper_q.satd_rows(al, bl, lg),
            lambda al=al, bl=bl, lg=log2: hopper_q.satd_rows_plain(al, bl, lg), (al, bl))
    for rows, k, log2, label in ((NCTU * 3, 256, 4, "prepass (8160*3,256)"),
                                 (LANES, 256, 4, "wave luma (68,256)"),
                                 (LANES, 64, 3, "wave chroma (68,64)")):
        c = t(rng.integers(-30000, 30000, (rows, k)).astype(np.int32))
        lv = t(rng.integers(-32768, 32768, (rows, k)).astype(np.int32))
        qp, dz = qrows(rows), dzrows(rows)
        add("quant", label,
            lambda c=c, qp=qp, dz=dz, l=log2: hopper_q.quantize_rows(c, qp, dz, l),
            lambda c=c, qp=qp, dz=dz, l=log2: hopper_q.quantize_rows_plain(c, qp, dz, l),
            (c, qp, dz))
        add("dequant", label,
            lambda lv=lv, qp=qp, l=log2: hopper_q.dequantize_rows(lv, qp, l),
            lambda lv=lv, qp=qp, l=log2: hopper_q.dequantize_rows_plain(lv, qp, l),
            (lv, qp))
    # the RDOQ route dequantizes a unit's Cb and Cr rows in one launch: the
    # CTB16 wave's (2 * 68, 64), a CTB64 CU16's (2 * 17, 64) and CU32's
    # (2 * 17, 256), the CU64 leaf's eight chroma TU16s (8 * 17, 256); and a
    # CU16's luma (17, 256)
    for rows, k, log2, label in ((2 * LANES, 64, 3, "RDOQ wave chroma (136,64)"),
                                 (LANES64, 256, 4, "RDOQ CU16 luma (17,256)"),
                                 (2 * LANES64, 64, 3, "RDOQ CU16 chroma (34,64)"),
                                 (2 * LANES64, 256, 4, "RDOQ CU32 chroma (34,256)"),
                                 (8 * LANES64, 256, 4, "RDOQ CU64 chroma (136,256)")):
        lv = t(rng.integers(-32768, 32768, (rows, k)).astype(np.int32))
        qp = qrows(rows)
        add("dequant", label,
            lambda lv=lv, qp=qp, l=log2: hopper_q.dequantize_rows(lv, qp, l),
            lambda lv=lv, qp=qp, l=log2: hopper_q.dequantize_rows_plain(lv, qp, l),
            (lv, qp))
    # residual coding: the IDR mode prepass (three candidate predictions per
    # original, qp per CTU, all intra) and one wave (luma and both chroma
    # planes of 68 lanes, qp and the intra/inter deadzone per lane)
    res_ops = OPS_PER_ELEM["residual"]
    po, pp, pq = pix(NCTU, 256), pix(NCTU * 3, 256), qrows(NCTU)
    cases.append(("residual", "prepass (8160*3,256) group 3",
                  lambda: hopper_q.code_residual_rows(po, pp, pq, True, 4, group=3),
                  lambda: hopper_q.code_residual_rows_plain(po, pp, pq, True, 4, group=3),
                  (po, pp, pq), res_ops[4] * pp.numel()))
    wave = [(pix(LANES, 256), pix(LANES, 256), qrows(LANES), 4)] + [
        (pix(LANES, 64), pix(LANES, 64), qrows(LANES), 3) for _ in range(2)]
    intra = t(rng.integers(0, 2, (LANES,)).astype(bool))
    cases.append(("residual", "wave 68 x (256 + 64 + 64)",
                  lambda: hopper_q.code_residual_planes(wave, intra),
                  lambda: [hopper_q.code_residual_rows_plain(o, p, q, intra, lg)
                           for o, p, q, lg in wave],
                  [x for o, p, q, _ in wave for x in (o, p, q)] + [intra],
                  sum(res_ops[lg] * p.numel() for _, p, _, lg in wave)))
    # SAO apply: luma 1088x1920 at ctb 16, chroma 544x960 at ctb 8; random
    # parameters covering off, band offset and all four edge classes; the
    # frame's three planes in one launch (the encoder's call), then one
    # plane a launch
    planes = []
    for h, w, ctb in ((1088, 1920, 16), (544, 960, 8), (544, 960, 8)):
        cbh, cbw = h // ctb, w // ctb
        rec = t(rng.integers(0, 256, (h, w)).astype(np.uint8))
        typ_np = rng.integers(0, 3, (cbh, cbw)).astype(np.int32)
        aux_np = np.where(typ_np == 2, rng.integers(0, 4, (cbh, cbw)),
                          rng.integers(0, 29, (cbh, cbw))).astype(np.int32)
        for v in range(3):
            assert (typ_np == v).any(), "SAO case misses a type"
        for k in range(4):
            assert ((typ_np == 2) & (aux_np == k)).any(), "SAO case misses an edge class"
        offs = t(rng.integers(-7, 8, (cbh, cbw, 4)).astype(np.int32))
        planes.append((rec, t(typ_np), t(aux_np), offs, ctb))
    cases.append(("sao", "frame: 3 planes, one launch", lambda: sao.sao_apply_planes(planes),
                  lambda: [sao.sao_apply_plain(*p[:4], ctb=p[4]) for p in planes],
                  [x for p in planes for x in p[:4]],
                  OPS_PER_ELEM["sao"] * sum(p[0].numel() for p in planes)))
    for (rec, typ, aux, offs, ctb), label in zip(planes[:2], ("luma (1088,1920) ctb16",
                                                            "chroma (544,960) ctb8")):
        add("sao", label,
            lambda r=rec, a=typ, b=aux, o=offs, c=ctb: sao.sao_apply(r, a, b, o, ctb=c),
            lambda r=rec, a=typ, b=aux, o=offs, c=ctb: sao.sao_apply_plain(r, a, b, o, ctb=c),
            (rec, typ, aux, offs))
    cases += quad64_cases(dev, rng, add)
    b64_cases(dev, rng, add)
    cases += merge_cases(dev, rng)
    return cases


def quad64_cases(dev, rng, add):
    """The CTB64 path's shapes at 1080p (30 x 17 CTBs, 17 lanes a wave):
    SATD of the CU64 ME vectors, of the IDR 32-grid mode sweep and of a
    wave's CU64 merge + ME candidates; quant and dequant of the TU32 prepass
    and wave rows; the fused residual kernel over a CU32's two 16x16 chroma
    blocks (512 threads), a CU16's planes and the CU64 leaf's chroma; SAO
    over the three planes at CTB 64 / 32."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pix(*s):
        return t(rng.integers(0, 256, s).astype(np.int32))

    def qrows(b):
        return t(rng.integers(0, 52, (b,)).astype(np.int32))

    cases = []
    # a wave's arbitration SATDs the K merge candidates and the ME vector
    # of its 17 lanes in one call: (K + 1) * 17 rows per CU64, CU32, CU16
    arb = [(f"CU{1 << lg} wave K={k} ({(k + 1) * LANES64},{1 << 2 * lg})", (k + 1) * LANES64,
            1, lg) for k in (1, 5) for lg in (6, 5, 4)]
    for label, rows, group, log2 in (("CU64 ME (510,4096)", NCTB64, 1, 6),
                                     ("IDR64 sweep (2040*35,1024) bcast", 4 * NCTB64 * 35, 35, 5),
                                     ("P64 intra (2040*11,1024) bcast", 4 * NCTB64 * 11, 11, 5),
                                     *arb):
        a, b = pix(rows, 1 << 2 * log2), pix(rows // group, 1 << 2 * log2)
        add("satd", label, lambda a=a, b=b, g=group, lg=log2: hopper_q.satd_rows(a, b, lg, g),
            lambda a=a, b=b, g=group, lg=log2: hopper_q.satd_rows_plain(a, b, lg, g), (a, b))
    for rows, label in ((4 * NCTB64 * 3, "TU32 prepass (2040*3,1024)"),
                        (NCTB64 * 8, "CU64 prepass (510*8,1024)"),
                        (LANES64, "TU32 wave (17,1024)"),
                        (4 * LANES64, "CU64 leaf wave (68,1024)")):
        c = t(rng.integers(-30000, 30000, (rows, 1024)).astype(np.int32))
        lv = t(rng.integers(-32768, 32768, (rows, 1024)).astype(np.int32))
        qp = qrows(rows)
        dz = t(np.where(rng.integers(0, 2, (rows,)) > 0, 171, 85).astype(np.int32))
        add("quant", label,
            lambda c=c, qp=qp, dz=dz: hopper_q.quantize_rows(c, qp, dz, 5),
            lambda c=c, qp=qp, dz=dz: hopper_q.quantize_rows_plain(c, qp, dz, 5), (c, qp, dz))
        add("dequant", label, lambda lv=lv, qp=qp: hopper_q.dequantize_rows(lv, qp, 5),
            lambda lv=lv, qp=qp: hopper_q.dequantize_rows_plain(lv, qp, 5), (lv, qp))
    res_ops = OPS_PER_ELEM["residual"]
    intra = t(rng.integers(0, 2, (LANES64,)).astype(bool))
    for label, lgs in (("CU32 chroma 17 x (256 + 256)", (4, 4)),
                       ("CU16 unit 17 x (256 + 64 + 64)", (4, 3, 3))):
        planes = [(pix(LANES64, 1 << 2 * lg), pix(LANES64, 1 << 2 * lg), qrows(LANES64), lg)
                  for lg in lgs]
        cases.append(("residual", label,
                      lambda pl=planes: hopper_q.code_residual_planes(pl, intra),
                      lambda pl=planes: [hopper_q.code_residual_rows_plain(o, p, q, intra, lg)
                                         for o, p, q, lg in pl],
                      [x for o, p, q, _ in planes for x in (o, p, q)] + [intra],
                      sum(res_ops[lg] * p.numel() for _, p, _, lg in planes)))
    po, pp, pq = pix(8 * LANES64, 256), pix(8 * LANES64, 256), qrows(8 * LANES64)
    cases.append(("residual", "CU64 leaf chroma (8*17,256)",
                  lambda: hopper_q.code_residual_rows(po, pp, pq, False, 4),
                  lambda: hopper_q.code_residual_rows_plain(po, pp, pq, False, 4),
                  (po, pp, pq), res_ops[4] * pp.numel()))
    planes = []
    for h, w, ctb in ((1088, 1920, 64), (544, 960, 32), (544, 960, 32)):
        cbh, cbw = h // ctb, w // ctb
        typ_np = rng.integers(0, 3, (cbh, cbw)).astype(np.int32)
        aux_np = np.where(typ_np == 2, rng.integers(0, 4, (cbh, cbw)),
                          rng.integers(0, 29, (cbh, cbw))).astype(np.int32)
        planes.append((t(rng.integers(0, 256, (h, w)).astype(np.uint8)), t(typ_np), t(aux_np),
                       t(rng.integers(-7, 8, (cbh, cbw, 4)).astype(np.int32)), ctb))
    cases.append(("sao", "CTB64 frame: 3 planes, one launch",
                  lambda pl=planes: sao.sao_apply_planes(pl),
                  lambda pl=planes: [sao.sao_apply_plain(*p[:4], ctb=p[4]) for p in pl],
                  [x for p in planes for x in p[:4]],
                  OPS_PER_ELEM["sao"] * sum(p[0].numel() for p in planes)))
    # a 1080-row frame as a decoder holds it: no plane is a CTB multiple
    # (1080 = 16 x 64 + 56, 540 = 16 x 32 + 28), at 8 and 10 bits a sample
    for bd in (8, 10):
        planes = []
        for h, w, ctb in ((1080, 1920, 64), (540, 960, 32), (540, 960, 32)):
            cbh, cbw = -(-h // ctb), -(-w // ctb)
            typ_np = rng.integers(0, 3, (cbh, cbw)).astype(np.int32)
            aux_np = np.where(typ_np == 2, rng.integers(0, 4, (cbh, cbw)),
                              rng.integers(0, 29, (cbh, cbw))).astype(np.int32)
            rec = rng.integers(0, 1 << bd, (h, w)).astype(np.uint8 if bd == 8 else np.uint16)
            planes.append((t(rec), t(typ_np), t(aux_np),
                           t(rng.integers(-7, 8, (cbh, cbw, 4)).astype(np.int32)), ctb))
        cases.append(("sao", f"1080-row frame bd {bd}: 3 planes, one launch",
                      lambda pl=planes, b=bd: sao.sao_apply_planes(pl, b),
                      lambda pl=planes, b=bd: [sao.sao_apply_plain(*p[:4], ctb=p[4], bd=b)
                                               for p in pl],
                      [x for p in planes for x in p[:4]],
                      OPS_PER_ELEM["sao"] * sum(p[0].numel() for p in planes)))
    return cases


def b64_cases(dev, rng, add) -> None:
    """The CTB64 B path's shapes at 1080p (`encoder/frame_b64.py`): SATD of
    the prepass's L0, L1 and BI costs at 64, 32 and 16 (one call for each);
    of a wave's arbitration, 5 merge candidates + L0 + L1 + BI per lane,
    for one picture (17 lanes) and pyramid levels of two and four (34 and
    68 lanes) at each CU size; and the RDOQ route's dequant rows of the
    levels of two and four."""
    def pix(*s):
        return torch.from_numpy(rng.integers(0, 256, s).astype(np.int32)).to(dev)

    def satd(label, rows, log2):
        a, b = pix(rows, 1 << 2 * log2), pix(rows, 1 << 2 * log2)
        add("satd", label, lambda: hopper_q.satd_rows(a, b, log2),
            lambda: hopper_q.satd_rows_plain(a, b, log2), (a, b))

    for rows, log2 in ((NCTB64, 6), (4 * NCTB64, 5), (16 * NCTB64, 4)):
        satd(f"B dense CU{1 << log2} ({rows},{1 << 2 * log2})", rows, log2)
    for nb in (1, 2, 4):
        for log2 in (6, 5, 4):
            rows = 8 * LANES64 * nb
            satd(f"B arbitration x{nb} CU{1 << log2} ({rows},{1 << 2 * log2})", rows, log2)
    for nb in (2, 4):  # one picture's rows are the P wave's (quad64_cases)
        lanes = nb * LANES64
        for rows, log2, label in ((lanes, 4, "CU16 luma"), (2 * lanes, 3, "CU16 Cb+Cr"),
                                  (lanes, 5, "CU32 luma"), (2 * lanes, 4, "CU32 Cb+Cr"),
                                  (4 * lanes, 5, "CU64 leaf luma"),
                                  (8 * lanes, 4, "CU64 leaf Cb+Cr")):
            lv = torch.from_numpy(rng.integers(-32768, 32768, (rows, 1 << 2 * log2))
                                  .astype(np.int32)).to(dev)
            qp = torch.from_numpy(rng.integers(0, 52, (rows,)).astype(np.int32)).to(dev)
            add("dequant", f"RDOQ B x{nb} {label} ({rows},{1 << 2 * log2})",
                lambda lv=lv, qp=qp, lg=log2: hopper_q.dequantize_rows(lv, qp, lg),
                lambda lv=lv, qp=qp, lg=log2: hopper_q.dequantize_rows_plain(lv, qp, lg),
                (lv, qp))


def merge_cases(dev, rng):
    """The P wave's merge search over a 1080p frame's luma strips (68 lanes,
    254 waves): 1, 3 and 5 candidates at three waves where most lanes hold
    a CTU, with every quarter-pel phase pair, MVs of -16 3/4 px (the filter reads
    outside the window), random ones far outside, equal last candidates,
    and lambda 0 in every fourth lane (tied costs)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ch, nw = 68, 254
    ref = t(rng.integers(0, 256, (1088 + 48, 1920 + 48)).astype(np.uint8))
    strips = sheared_ref_strips(ref, 16, 16, ch, 24)
    oy_w = t(rng.integers(0, 256, (nw, LANES, 256)).astype(np.int32))
    lam_np = (rng.random((nw, LANES)) * 150).astype(np.float32)
    lam_np[:, ::4] = 0.0
    lam_w = t(lam_np)
    cases = []
    for k_cands, d in ((1, 130), (3, 90), (5, 170)):
        ms = merge.MergeSearch(strips, oy_w, lam_w, k_cands)
        mvs = rng.integers(-80, 81, (k_cands, LANES, 2)).astype(np.int32)
        mvs[0, :, 0] = 4 * rng.integers(-17, 17, LANES) + np.arange(LANES) % 4
        mvs[0, :, 1] = 4 * rng.integers(-17, 17, LANES) + np.arange(LANES) // 4 % 4
        mvs[0, :8] = (-67, -66)
        if k_cands > 2:
            mvs[-2] = mvs[-1]
        cands = [t(m) for m in mvs]
        winy = strip_window_slice(strips, d, 16, 16)
        cases.append(("merge", f"K={k_cands} wave {d} (68 lanes)",
                      lambda ms=ms, d=d, c=cands: ms.wave(d, c),
                      lambda w=winy, d=d, c=cands: merge.merge_search_plain(
                          w, c, oy_w[d], lam_w[d], 16, 16),
                      [winy, torch.stack(cands), oy_w[d], lam_w[d]],
                      OPS_PER_ELEM["merge"] * k_cands * LANES))
    return cases


def outputs(out) -> list:
    """A kernel's output tensors, in order (nested tuples and lists flattened)."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in outputs(o)]
    return [out]


def bound(operands, out, n_ops) -> tuple[float, str]:
    """The least time the card could take for one call: each operand read
    once and each output written once over the memory rate, against the
    n_ops operations over the peak rate; returns (ms, what bounds it)."""
    nbytes = sum(x.numel() * x.element_size() for x in [*operands, *outputs(out)])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(x):
    """x as int64 for an exact comparison: integers by value, float32 by
    its bit pattern (so 0 means bit-identical)."""
    return (x.view(torch.int32) if x.dtype == torch.float32 else x).to(torch.int64)


def check_kernels(cases) -> dict:
    """Kernel == plain on every case; returns max abs error per kernel."""
    err = {}
    for name, label, kfn, pfn, _, _ in cases:
        got, want = outputs(kfn()), outputs(pfn())
        torch.cuda.synchronize()
        if [(g.shape, g.dtype) for g in got] != [(w.shape, w.dtype) for w in want]:
            raise AssertionError(f"{name} {label}: {[(g.shape, g.dtype) for g in got]} vs "
                                 f"{[(w.shape, w.dtype) for w in want]}")
        e = max(int((bits(g) - bits(w)).abs().max()) for g, w in zip(got, want))
        log(f"  {name:8s} {label:30s} max_abs_err={e} (tolerance 0)")
        if e != 0:
            raise AssertionError(f"{name} {label}: kernel disagrees with plain version")
        err[name] = max(err.get(name, 0), e)
    return err


def check_ties(dev) -> None:
    """First index wins on ties (argmin) and sorting keeps index order."""
    x = torch.tensor([[5.0, 1.0, 3.0, 1.0, 1.0]] * 4096, device=dev)
    if not bool((x.argmin(dim=1) == 1).all()):
        raise AssertionError("argmin does not return the first minimal index on cuda")
    idx = torch.sort(x, dim=1, stable=True).indices[:, :3]
    if not bool((idx == torch.tensor([1, 3, 4], device=dev)).all()):
        raise AssertionError("stable sort does not keep index order on ties on cuda")
    i2 = torch.stack([x[:, 1], x[:, 3]]).argmin(dim=0)
    if not bool((i2 == 0).all()):
        raise AssertionError("argmin over dim 0 does not return the first index")
    # the prepasses' top-k (the reference's lax.top_k of -cost): the k
    # lowest of 35 costs per row, the lower index first on ties, over more
    # rows than a sort kernel's single block
    cost = torch.tensor(np.random.default_rng(3).integers(0, 4, (4 * NCTB64, 35)),
                        dtype=torch.float32, device=dev)
    want = np.argsort(cost.cpu().numpy(), axis=1, kind="stable")
    for k in (2, 3):
        got = torch.sort(cost, dim=1, stable=True).indices[:, :k].cpu().numpy()
        if not np.array_equal(got, want[:, :k]):
            raise AssertionError(f"stable-sort top-{k} does not keep index order on ties")
    log("  argmin / stable-sort / top-k ties: first index wins")


def check_rdoq(dev) -> None:
    """RDOQ is plain PyTorch on every device: on the card it must equal the
    CPU element for element (no TF32, no device-specific rounding in its
    float32 costs) at every QP, block size and deadzone, with coefficients
    up to |32767| and lambda^2 from 0.05 to 10^5."""
    rng = np.random.default_rng(52)
    for log2 in (2, 3, 4, 5):
        for intra in (True, False):
            qp = torch.from_numpy(np.repeat(np.arange(52, dtype=np.int32), 16))
            shape = (len(qp), 1 << 2 * log2)
            coef = torch.from_numpy((rng.choice([-1, 1], shape) * np.exp(
                rng.uniform(0, np.log(32767), shape))).astype(np.int32))
            lam2 = torch.from_numpy(np.exp(rng.uniform(-3, np.log(1e5), len(qp)))
                                    .astype(np.float32))
            want = quant.quantize_rdoq(coef, qp, log2, lam2, intra)
            got = quant.quantize_rdoq(coef.to(dev), qp.to(dev), log2, lam2.to(dev), intra)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"quantize_rdoq on cuda differs from the CPU at {log2=}, "
                                     f"{intra=}")
    log("  quantize_rdoq on cuda == on the CPU: 52 QPs x 4x4..32x32 x intra / inter")


def golden_config(golden):
    """The stream configuration a golden was written with."""
    gcfg = golden["config"]
    cfg = stream_config(golden["width"], golden["height"], qp=golden["qp"],
                        merge=golden["merge_cand"], sao=gcfg["sao"], wpp=gcfg["wpp"],
                        tmvp=gcfg["tmvp"], rdoq=gcfg["rdoq"], ctu=1 << gcfg["ctb_log2"],
                        gop=gcfg.get("gop", "ld"))
    if ((cfg.sao_enabled, cfg.wpp, cfg.temporal_mvp, cfg.rdoq, cfg.ctb_log2)
            != (gcfg["sao"], gcfg["wpp"], gcfg["tmvp"], gcfg["rdoq"], gcfg["ctb_log2"])
            or cfg.min_cb_log2 != gcfg.get("min_cb_log2", cfg.min_cb_log2)
            or cfg.max_tb_log2 != gcfg.get("max_tb_log2", cfg.max_tb_log2)):
        raise AssertionError(f"configuration differs from the golden's: {gcfg}")
    return cfg


def recon_sha256(recon) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes() for p in recon)).hexdigest()


def check_launches(cfg, kinds, counts) -> None:
    """Every kernel of the path launched, exactly as `expected_launches`
    counts for frames of `kinds`."""
    want = expected_launches(cfg, kinds)
    zero = [k for k, v in want.items() if v and counts[k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: {zero}")
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"launches per encode (got, expected): {bad}")


def encode_1080p(dev, golden, n: int) -> tuple[list, dict]:
    """Encode the first n of the golden's frames with its configuration and
    hold every frame against it; returns the per-frame rows and the kernel
    launches of the measured encode alone."""
    w, h = golden["width"], golden["height"]
    cfg = golden_config(golden)
    python_cabac = cfg.sao_enabled and cfg.ctb_log2 == 4  # SAO at CTB16: the Python tier
    frames = synthetic_frames(w, h, n, seed=golden["seed"])
    # warm-up on a throwaway encoder (one IDR and one P): cuBLAS handles,
    # allocator pools, constant tables; the first path also builds the
    # native CABAC library, the CTB16 SAO path warms only its device stage
    warm = Encoder(cfg, intra_period=golden["intra_period"], device=dev)
    for (y, u, v) in frames[:2]:
        ctx = warm.encode_frame_device(y, u, v)
        if not python_cabac:
            warm.encode_frame_entropy(ctx)
    torch.cuda.synchronize()

    enc = Encoder(cfg, intra_period=golden["intra_period"], device=dev)
    reset_launches()
    rows = []
    for i, (y, u, v) in enumerate(frames):
        t0 = time.perf_counter()
        ctx = enc.encode_frame_device(y, u, v)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream, recon = enc.encode_frame_entropy(ctx)
        t2 = time.perf_counter()
        rows.append({"frame": i, "kind": ctx["kind"], "bytes": len(stream),
                     "sha256": hashlib.sha256(stream).hexdigest(),
                     "recon_sha256": recon_sha256(recon),
                     "device_ms": (t1 - t0) * 1e3, "entropy_ms": (t2 - t1) * 1e3,
                     "recon_shape": [list(p.shape) for p in recon]})
    counts = launches()
    for r, g in zip(rows, golden["frames"]):
        match = r["sha256"] == g["sha256"] and r["bytes"] == g["bytes"]
        log(f"  frame {r['frame']} ({r['kind']}): {r['bytes']} bytes "
            f"(golden {g['bytes']}) sha256 {'match' if match else 'MISMATCH'}; "
            f"recon {'match' if r['recon_sha256'] == g['recon_sha256'] else 'MISMATCH'}; "
            f"device {r['device_ms']:.1f} ms, entropy {r['entropy_ms']:.1f} ms")
    log(f"  kernel launches during the encode: {counts}")
    bad = [r["frame"] for r, g in zip(rows, golden["frames"])
           if r["sha256"] != g["sha256"] or r["bytes"] != g["bytes"]
           or r["recon_sha256"] != g["recon_sha256"]]
    if len(rows) != n or n > len(golden["frames"]) or bad:
        raise AssertionError(f"1080p stream or recon differs from the JAX golden in frames {bad}")
    if rows[0]["recon_shape"] != [[h, w], [h // 2, w // 2], [h // 2, w // 2]]:
        raise AssertionError(f"unexpected recon shape {rows[0]['recon_shape']}")
    check_launches(cfg, [r["kind"] for r in rows], counts)
    return rows, counts


def pipelined_1080p(dev, golden, n: int, seq_rows) -> tuple[dict, dict]:
    """The golden's first n frames through PipelinedEncoder (depth 3, recon
    fetched), every frame held against the golden; returns the e2e figures
    beside the sequential encode's (`seq_rows`, phase 3) and the launches."""
    cfg = golden_config(golden)
    frames = synthetic_frames(golden["width"], golden["height"], n, seed=golden["seed"])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with PipelinedEncoder(cfg, intra_period=golden["intra_period"], depth=3,
                          device=dev) as pe:
        out = []
        for f in frames:
            out += pe.push(*f)
        out += pe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage = dict(pe.stage)
    counts = launches()
    bad = [i for i, ((s, r), g) in enumerate(zip(out, golden["frames"]))
           if hashlib.sha256(s).hexdigest() != g["sha256"] or len(s) != g["bytes"]
           or recon_sha256(r) != g["recon_sha256"]]
    if len(out) != n or bad:
        raise AssertionError(f"pipelined stream or recon differs from the golden in {bad}")
    quad = cfg.ctb_log2 == 6
    kinds = [("quad" if quad else "idr") if i % golden["intra_period"] == 0
             else ("quad_p" if quad else "p") for i in range(n)]
    check_launches(cfg, kinds, counts)
    seq_s = sum(r["device_ms"] + r["entropy_ms"] for r in seq_rows[:n]) / 1e3
    res = {"frames": n, "wall_s": wall, "e2e_fps": n / wall, "sequential_s": seq_s,
           "sequential_fps": n / seq_s, **stage}
    log(f"  {n} frames match the golden; e2e {res['e2e_fps']:.3f} fps ({wall:.2f} s) "
        f"against sequential {res['sequential_fps']:.3f} fps ({seq_s:.2f} s: "
        f"device + entropy of phase 3); fetch {stage['fetch_s']:.3f} s, "
        f"{stage['fetch_bytes']} bytes; cabac {stage['cabac_s']:.3f} s")
    log(f"  kernel launches during the pipelined encode: {counts}")
    return res, counts


def encode_ra_1080p(dev, golden) -> tuple[list, dict, int]:
    """The RA golden's frames through QuadRABatchEncoder on the card (no
    warm-up of its own: the earlier phases ran the CTB64 I and P engines
    and the shared machinery); every picture is held against the golden in
    decode order.  Returns the per-picture rows, the kernel launches and
    the peak device memory in bytes."""
    w, h = golden["width"], golden["height"]
    cfg = golden_config(golden)
    frames = synthetic_frames(w, h, golden["n_frames"], seed=golden["seed"])
    enc = QuadRABatchEncoder(cfg, gop_size=8, intra_period=golden["intra_period"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = []
    for f in frames:
        out += enc.push_frame(*f)
    out += enc.flush()
    torch.cuda.synchronize()
    counts = launches()
    peak = torch.cuda.max_memory_allocated(dev)
    rows = []
    times = {tm["poc"]: tm for tm in enc.times}
    for poc, stream, recon in out:
        tm = times[poc]
        rows.append({"poc": poc, "kind": tm["kind"], "batch": tm["batch"], "bytes": len(stream),
                     "sha256": hashlib.sha256(stream).hexdigest(),
                     "recon_sha256": recon_sha256(recon), "device_ms": tm["device_ms"],
                     "entropy_ms": tm["entropy_ms"]})
    bad = []
    for r, g in zip(rows, golden["frames"]):
        ok = (r["poc"], r["bytes"], r["sha256"]) == (g["poc"], g["bytes"], g["sha256"])
        rok = r["recon_sha256"] == g["recon_sha256"]
        log(f"  POC {r['poc']} ({r['kind']}, device call of {r['batch']}): {r['bytes']} bytes "
            f"(golden POC {g['poc']}, {g['bytes']}) sha256 {'match' if ok else 'MISMATCH'}; "
            f"recon {'match' if rok else 'MISMATCH'}; device {r['device_ms']:.1f} ms "
            f"(its share of the call), entropy {r['entropy_ms']:.1f} ms")
        if not (ok and rok):
            bad.append(r["poc"])
    log(f"  kernel launches during the RA encode: {counts}")
    log(f"  peak device memory: {peak} bytes ({peak / 2**20:.1f} MiB)")
    if len(rows) != len(golden["frames"]) or bad:
        raise AssertionError(f"RA stream or recon differs from the JAX golden at POCs {bad}")
    check_launches(cfg, list(RA_CALLS), counts)
    return rows, counts, peak


def expected_launches(cfg, kinds) -> dict:
    """Each kernel's launches in an encode of frames of `kinds`, counted
    from the code of the path.

    CTB16: the residual kernel once per wave of every frame and once per
    IDR mode prepass; the merge search once per P wave; SATD for the IDR
    mode prepass, and for each P frame's ME cost and intra cost prepass;
    quant and dequant never (the encoder reaches them only through the
    residual kernel).

    CTB64 IDR: the prepasses launch SATD twice (the 16- and 32-grid
    sweeps), the residual kernel once (16-grid RD) and quant + dequant
    twice (the 32-grid and CU64 RD, 32x32 blocks); each wave codes per
    32-quadrant a CU32 (quant + dequant for its TU32, one residual launch
    for its two TU16 chroma blocks) and four CU16s (one residual launch
    each), and the CU64 leaf's four TU32 units likewise: 24 residual and
    8 quant + dequant a wave.  CTB64 P: SATD five times in the prepasses
    (the ME costs at 64, 32, 16 and the intra estimates at 32, 16); each
    wave 21 arbitrations (one SATD each: four CU32s, sixteen CU16s, the
    CU64), one residual launch per CU32 and CU16 and one for the CU64
    leaf's eight chroma TU16s, quant + dequant per CU32 and once for the
    CU64's four TU32s.  SAO once per frame with SAO on; no merge search.

    CTB64 B (kind "quad_bN": one device call of N pictures, a pyramid
    level side by side in the lanes): SATD 11 times per picture in the
    prepasses (the L0, L1 and BI costs at 64, 32 and 16, the intra
    estimates at 32 and 16) and 21 times a wave (one per arbitration); the
    residual coding as in a P wave.

    With RDOQ the prepasses are unchanged and every wave's residual coding
    takes the RDOQ route: no residual or quant launch, one dequant launch
    per block size of a unit (Cb and Cr stacked).  CTB16: 2 a wave (luma
    16x16, chroma 8x8).  CTB64 IDR: per 32-quadrant a CU32 (32x32, 16x16)
    and four CU16s (16x16, 8x8), and the CU64 leaf's four units (32x32,
    16x16): 48 a wave.  CTB64 P and B: four CU32s and sixteen CU16s (2
    each) and the CU64 leaf's TU32 luma and TU16 chroma (1 each): 42 a
    wave."""
    n_waves = schedule_r(cfg.ctbs_w, cfg.ctbs_h)["n_waves"]
    b_calls = [int(k[len("quad_b"):]) for k in kinds if k.startswith("quad_b")]
    n_idr = sum(k in ("idr", "quad") for k in kinds)
    n_p = sum(k in ("p", "quad_p") for k in kinds)
    n_pics = n_idr + n_p + sum(b_calls)
    sao_n = n_pics if cfg.sao_enabled else 0
    if cfg.ctb_log2 == 4:
        counts = {"residual": n_pics * n_waves + n_idr, "merge": n_p * n_waves,
                  "satd": n_idr + 2 * n_p, "sao": sao_n, "quant": 0, "dequant": 0}
        if cfg.rdoq:
            counts.update(residual=n_idr, dequant=2 * n_pics * n_waves)
        return counts
    n_inter = n_p + len(b_calls)  # device calls with inter waves
    satd = 2 * n_idr + n_p * (5 + 21 * n_waves) + sum(11 * nb + 21 * n_waves for nb in b_calls)
    if cfg.rdoq:
        return {"residual": n_idr, "merge": 0, "satd": satd, "sao": sao_n, "quant": 2 * n_idr,
                "dequant": n_idr * (2 + 48 * n_waves) + n_inter * 42 * n_waves}
    q = n_idr * (2 + 8 * n_waves) + n_inter * 5 * n_waves
    return {"residual": n_idr * (1 + 24 * n_waves) + n_inter * 21 * n_waves, "merge": 0,
            "satd": satd, "sao": sao_n, "quant": q, "dequant": q}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    dev = runtime.require_cuda()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)

    log("phase 1: kernel build")
    t0 = time.perf_counter()
    so = runtime.build_kernels(verbose=True)
    runtime.kernel_lib()
    log(f"  built {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain versions at main-path shapes")
    cases = kernel_cases(dev)
    errs = check_kernels(cases)
    check_ties(dev)
    check_rdoq(dev)

    frames, total, seq, goldens = {}, dict.fromkeys(KERNELS, 0), {}, {}
    for label, name, n in PATHS:
        log(f"phase 3: 1080p IDR+{n - 1}P {label} encode on cuda vs JAX golden {name}")
        with open(os.path.join(GOLDEN_DIR, name)) as f:
            goldens[name] = json.load(f)
        rows, counts = encode_1080p(dev, goldens[name], n)
        seq[name] = rows
        frames[label] = [{k: r[k] for k in ("frame", "kind", "bytes", "device_ms",
                                             "entropy_ms")} for r in rows]
        for k in KERNELS:
            total[k] += counts[k]

    pipelined = {}
    for name, n in PIPELINED:
        log(f"phase 4: PipelinedEncoder (depth 3), 1080p, the first {n} frames of {name}")
        pipelined[name], counts = pipelined_1080p(dev, goldens[name], n, seq[name])
        for k in KERNELS:
            total[k] += counts[k]

    log(f"phase RA: 1080p random access on cuda vs JAX golden {RA_GOLDEN}")
    with open(os.path.join(GOLDEN_DIR, RA_GOLDEN)) as f:
        ra_rows, counts, ra_peak = encode_ra_1080p(dev, json.load(f))
    for k in KERNELS:
        total[k] += counts[k]

    log("phase 5: kernel vs plain times (CUDA events, mean of 20 calls, least of 5 runs; "
        "device: profiler, mean of 20 calls)")
    times = {}
    for name, label, kfn, pfn, operands, n_ops in cases:
        km, pm = cuda_ms(kfn), cuda_ms(pfn)
        dm = device_ms(name, kfn)
        bms, by = bound(operands, kfn(), n_ops)
        dev_txt = "not measured" if dm is None else f"{dm:.4f} ms"
        log(f"  {name:8s} {label:30s} kernel {km:.4f} ms  device {dev_txt}  "
            f"plain {pm:.4f} ms  bound {bms:.4f} ms ({by})")
        # the first case of each kernel stands for it in the kernels line
        times.setdefault(name, (km, pm, bms, by, dm))
    kernels = [{"name": n, "route": "cuda", "source": SOURCE[n], "replaces": REPLACES[n],
                "launches": total[n], "max_abs_err": errs[n], "ms": times[n][0],
                "plain_ms": times[n][1], "bound_ms": times[n][2], "bound_by": times[n][3],
                "library_ms": None, "device_ms": times[n][4]}
               for n in KERNELS]
    log(json.dumps({"frames": frames, "pipelined": pipelined,
                    "ra": {"pictures": [{k: r[k] for k in ("poc", "kind", "batch", "bytes",
                                                           "device_ms", "entropy_ms")}
                                        for r in ra_rows],
                           "launches": counts, "peak_bytes": ra_peak}}))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
