"""Closed-loop frame-level rate control: target bitrate -> per-frame QP.

Counterpart of kvazaar's rate_control.c frame-level allocator as driven by
the reference (kvazaarfilter.cpp maps `videoBitrate` into kvz config; the
RTCP loop then retargets it live via ResourceAllocator).  The TPU build
keeps rate control on the host — it is pure scalar bookkeeping between
frames — and feeds the encoder a plain int QP, which is a *traced* input
of the jitted wavefront (core/params.py), so QP changes never recompile.

Model: R-lambda-lite.  Maintain a virtual buffer of bit debt; map the
per-frame bit budget to QP through a running bits-per-QP model updated
from what each frame actually produced (exponential forgetting).  This is
the same control structure as kvazaar's `gop_allocate_bits` +
`lambda_to_qp` chain, reduced to the low-delay case.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class RateControlState:
    bits_balance: float = 0.0  # >0: under budget (may spend), <0: overspent
    model_bits: float = 0.0  # EWMA of bits produced at model_qp
    model_qp: float = 0.0
    frames: int = 0


class RateController:
    """Per-frame QP decisions toward `bitrate` bits/s at `fps` frames/s.

    Usage:
        rc = RateController(bitrate=2_000_000, fps=30, base_qp=32)
        qp = rc.frame_qp(is_idr)
        ... encode with qp ...
        rc.update(qp, nbytes * 8)
    """

    def __init__(self, bitrate: int, fps: float, base_qp: int = 32,
                 qp_min: int = 10, qp_max: int = 48, intra_weight: float = 3.0):
        self.bitrate = float(bitrate)
        self.fps = float(fps)
        self.qp = float(base_qp)
        self.qp_min, self.qp_max = qp_min, qp_max
        self.intra_weight = intra_weight  # IDR frames earn a bigger budget
        self.st = RateControlState(model_qp=float(base_qp))

    # ------------------------------------------------------------- policy
    @property
    def frame_budget(self) -> float:
        return self.bitrate / self.fps

    def retarget(self, bitrate: int) -> None:
        """Live bitrate change (RTCP feedback via ResourceAllocator)."""
        self.bitrate = float(max(64_000, bitrate))

    def frame_qp(self, is_idr: bool = False) -> int:
        st = self.st
        budget = self.frame_budget * (self.intra_weight if is_idr else 1.0)
        # spend the balance over ~1 second so transients don't oscillate QP
        target = budget + st.bits_balance / self.fps
        target = max(budget * 0.1, target)
        if st.model_bits > 0:
            # bits roughly halve every +6 QP (the quantizer step doubles
            # every 6 — HEVC 8.6.3 Qstep = 2^((qp-4)/6))
            dq = 6.0 * math.log2(st.model_bits / target)
            qp = st.model_qp + dq
        else:
            qp = self.qp
        # slew limit: +-3 QP between consecutive frames, +-6 for IDR resets
        limit = 6.0 if is_idr else 3.0
        qp = min(max(qp, self.qp - limit), self.qp + limit)
        qp = min(max(qp, self.qp_min), self.qp_max)
        self.qp = qp
        return int(round(qp))

    def update(self, qp_used: int, bits_produced: float, is_idr: bool = False) -> None:
        st = self.st
        budget = self.frame_budget * (self.intra_weight if is_idr else 1.0)
        st.bits_balance += budget - bits_produced
        # clamp the buffer to one second of credit/debt
        st.bits_balance = min(max(st.bits_balance, -self.bitrate), self.bitrate)
        # fold this observation into the bits(QP) model, normalized to qp_used
        alpha = 0.25 if st.frames else 1.0
        if st.frames:
            # translate the stored model to this frame's QP before mixing
            st.model_bits *= 2.0 ** ((st.model_qp - qp_used) / 6.0)
        st.model_qp = float(qp_used)
        w = self.intra_weight if is_idr else 1.0
        st.model_bits = (1 - alpha) * st.model_bits + alpha * (bits_produced / w)
        st.frames += 1
