"""The P wave's merge-candidate search in one hand-written Hopper kernel.

For every lane of a wave and each of its K merge candidates: luma MC of
the candidate from the lane's reference window, its SATD against the
original, the cost `fma(lambda, 2 + merge_idx bits, SATD)`, then the first
candidate of least cost (counterpart of the merge block of
kvazzup_tpu/encoder/frame_inter.py:471-490, whose SATD is the Pallas
`_satd_kernel`).

`MergeSearch` is set up once per P frame over the frame's sheared luma
strips, its wave-order originals and lambdas, with one output buffer per
result for all waves; `MergeSearch.wave(d, cands)` searches wave d and
returns views of wave d's rows.  On CPU tensors it runs
`merge_search_plain`; on CUDA tensors it launches `kvz_merge_search`
(`csrc/merge_kernels.cu`) once per wave, or raises.  `LAUNCHES` counts
kernel launches; the plain version never touches it.
"""

from __future__ import annotations

import torch

from .. import runtime
from .costs import fma
from .hopper_q import satd_rows_plain
from .mc import _win_geom, mc_luma_window_batch, mc_window_origin, strip_window_slice

LAUNCHES = {"merge": 0}
MAX_CANDS = 5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def merge_search_plain(winy, cands, oyw, lamf, n: int, search_range: int):
    """Merge search of one wave in plain PyTorch.

    winy (lanes, win, win) uint8 reference windows; cands a sequence of K
    (lanes, 2) int32 quarter-pel MVs; oyw (lanes, n*n) int32 originals;
    lamf (lanes,) float32.  Returns merge_idx (lanes,) int32, its cost
    (lanes,) float32, its MV (lanes, 2) int32 and its prediction (lanes,
    n*n) int32; equal costs keep the first candidate.  Plain PyTorch on any
    device (the SATD too)."""
    K = len(cands)
    lanes = oyw.shape[0]
    log2 = n.bit_length() - 1
    preds_m, costs_m = [], []
    for k in range(K):
        idx_bits = float(min(k + 1, K - 1)) if K > 1 else 0.0
        pk = mc_luma_window_batch(winy, cands[k], n, search_range).reshape(lanes, -1)
        satd_k = satd_rows_plain(pk, oyw, log2).to(torch.float32)
        costs_m.append(fma(lamf, 2.0 + idx_bits, satd_k))
        preds_m.append(pk)
    costs_s = torch.stack(costs_m)  # (K, lanes)
    merge_idx = costs_s.argmin(dim=0)
    cost_merge = costs_s.gather(0, merge_idx[None])[0]
    merge_mv = torch.stack(list(cands)).gather(
        0, merge_idx[None, :, None].expand(1, lanes, 2))[0]
    pred = torch.stack(preds_m).gather(
        0, merge_idx[None, :, None].expand(1, lanes, n * n))[0]
    return merge_idx.to(torch.int32), cost_merge, merge_mv, pred


class MergeSearch:
    """The merge search of one P frame, wave by wave.

    strips_y: the frame's (lanes, win, total) uint8 sheared luma strips
    (`mc.sheared_ref_strips`); oy_w (n_waves, lanes, n*n) int32 and lam_w
    (n_waves, lanes) float32 in wave order; k_cands 1..5.  The kernel is
    written for the CTB16 path: n = 16, search range 16.  The operands are
    checked, and their addresses taken, once here."""

    def __init__(self, strips_y, oy_w, lam_w, k_cands: int, n: int = 16,
                 search_range: int = 16):
        if (n, search_range) != (16, 16):
            raise ValueError(f"merge search: CTB16 only (n 16, range 16), got {n}, {search_range}")
        if not 1 <= k_cands <= MAX_CANDS:
            raise ValueError(f"merge search: 1..{MAX_CANDS} candidates, got {k_cands}")
        runtime.check_operand(lam_w, "lam_w", 2, dtype=torch.float32)
        nw, lanes = lam_w.shape
        _, _, win = _win_geom(n, search_range, False)
        runtime.check_operand(oy_w, "oy_w", 3, (nw, lanes, n * n))
        runtime.check_operand(strips_y, "strips_y", 3, dtype=torch.uint8)
        if strips_y.shape[:2] != (lanes, win) or strips_y.shape[2] < win:
            raise ValueError(f"strips_y: expected ({lanes}, {win}, >= {win}), "
                             f"got {tuple(strips_y.shape)}")
        self.strips, self.oy_w, self.lam_w = strips_y, oy_w, lam_w
        self.k_cands, self.n, self.search_range, self.lanes = k_cands, n, search_range, lanes
        dev = lam_w.device
        self.merge_idx = torch.empty((nw, lanes), dtype=torch.int32, device=dev)
        self.cost = torch.empty((nw, lanes), dtype=torch.float32, device=dev)
        self.mv = torch.empty((nw, lanes, 2), dtype=torch.int32, device=dev)
        self.pred = torch.empty((nw, lanes, n * n), dtype=torch.int32, device=dev)
        # wave d's rows of the four buffers, as views made once
        self._outs = list(zip(*(t.unbind(0) for t in (self.merge_idx, self.cost, self.mv,
                                                       self.pred))))
        self.cuda = runtime.kernel_route(strips_y, oy_w, lam_w)
        if self.cuda:
            # the kernel's pointer arguments per wave: the window at the
            # clamped start column, the wave's original and lambda rows, the
            # wave's rows of the output buffers
            total = strips_y.shape[2]
            addr = [(t.data_ptr(), t[0].numel() * t.element_size())
                    for t in (oy_w, lam_w, self.merge_idx, self.cost, self.mv, self.pred)]
            self._args = [(strips_y.data_ptr() + min(n * d, total - win), win * total, total)
                          + tuple(base + d * step for base, step in addr)
                          for d in range(nw)]
            self._org = mc_window_origin(search_range, False)

    def wave(self, d: int, cands):
        """Search wave d over the candidates `cands` (K (lanes, 2) int32
        tensors); returns (merge_idx, cost, mv, pred), views of wave d's
        rows of the frame's buffers."""
        outs = self._outs[d]
        if len(cands) != self.k_cands:
            raise ValueError(f"merge search: {len(cands)} candidates, set up for {self.k_cands}")
        if not self.cuda:
            winy = strip_window_slice(self.strips, d, self.n, self.search_range)
            got = merge_search_plain(winy, cands, self.oy_w[d], self.lam_w[d], self.n,
                                     self.search_range)
            for o, g in zip(outs, got):
                o.copy_(g)
            return outs
        mvs = torch.stack(cands)
        if mvs.dtype != torch.int32 or mvs.shape != (self.k_cands, self.lanes, 2):
            raise ValueError(f"merge candidates: expected {self.k_cands} int32 ({self.lanes}, 2) "
                             f"tensors, got {mvs.dtype} {tuple(mvs.shape)}")
        if mvs.device != self.lam_w.device:
            raise ValueError(f"merge candidates on {mvs.device}, frame on {self.lam_w.device}")
        win, lane_stride, row_stride, orig, lam, idx, cost, mv, pred = self._args[d]
        with runtime.on_device(mvs):
            err = runtime.kernel_lib().kvz_merge_search(
                win, lane_stride, row_stride, mvs.data_ptr(), orig, lam, self.lanes,
                self.k_cands, self._org, idx, cost, mv, pred, runtime.stream_ptr(mvs))
        runtime.check_launch(err, "merge")
        LAUNCHES["merge"] += 1
        return outs
