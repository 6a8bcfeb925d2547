"""Level-batched RA B pyramid (counterpart of
kvazzup_tpu/encoder/ra_batch.py, `QuadRABatchEncoder`).

The mini-GOP is a dependency graph, not a chain: in a gop8 (decode order
P8, B4, B2, B1, B3, B6, B5, B7, `ra._GOP8`), B2 and B6 depend only on the
anchors {0, 4, 8}, and the four layer-3 pictures {B1, B3, B5, B7} only on
{0, 2, 4, 6, 8}.  Each such level shares one temporal layer (equal QP
offset) and equal POC distances, so the whole level goes through one call
of `encode_frame_b64_fast` with a leading batch axis: its 62-wave 1080p
loop runs once with 2x or 4x the lanes.  A gop8's device path drops from
8 picture scans to 4 (P8, B4, {B2, B6}, {B1, B3, B5, B7}).

The streams are byte-identical to `QuadRAEncoder`: the batched engine
runs the same per-lane arithmetic, the per-picture tail (trees, loop
filters, entropy) is the same code (`_finish_b`), NAL emission stays in
decode order and the DPB pruning replays the sequential order.
"""

from __future__ import annotations

import time

import torch

from .frame_b64 import encode_frame_b64_fast
from .ra import QuadRAEncoder


class QuadRABatchEncoder(QuadRAEncoder):
    """QuadRAEncoder with the B pictures of a pyramid level batched through
    one device call.  Same API, byte-identical streams."""

    # schedule indices (into _GOP8 / _GOP4) that form batchable levels:
    # equal temporal layer and POC distances, references all coded by the
    # time the level's first entry comes up in decode order
    _LEVELS = {8: ((2, 5), (3, 4, 6, 7)), 4: ((2, 3),)}

    def _code_b_level(self, items, qp):
        """items: [(frame, poc, p0, p1, layer, rps)] with equal layer and
        POC distances: one batched device call, then each picture's tail in
        list order."""
        cfg = self.cfg
        t0 = time.perf_counter()
        qp = self._layer_qp(qp, items[0][4])
        planes = [self._planes(it[0]) for it in items]
        refs = [(*self._dpb[it[2]], *self._dpb[it[3]]) for it in items]
        stacked = [torch.stack([p[c] for p in planes]) for c in range(3)] + [
            torch.stack([r[c] for r in refs]) for c in range(6)]
        poc, p0, p1 = items[0][1:4]
        out = encode_frame_b64_fast(*stacked, qp, (poc - p0, poc - p1), width=cfg.width,
                                    height=cfg.height, merge_cand=cfg.merge_cand, rdoq=cfg.rdoq)
        self._sync()
        share = (time.perf_counter() - t0) * 1e3 / len(items)
        return [self._finish_b(planes[b], {key: val[b] for key, val in out.items()}, it[1], qp,
                               it[5], time.perf_counter(), len(items), share)
                for b, it in enumerate(items)]

    def _code_group(self, qp):
        a0 = self._anchor_poc
        frames, self._pending = self._pending, []
        sched = self.sched
        level_of = {i: lvl for lvl in self._LEVELS[self.gop_size] for i in lvl}
        results: dict = {}
        for i, (off, l0, l1, layer, neg, pos) in enumerate(sched):
            if i in results:
                continue
            poc = a0 + off
            if l1 is None:
                results[i] = self._code_anchor(frames[off - 1], poc, a0, layer, (neg, pos), qp)
            elif i in level_of:
                lvl = level_of[i]
                items = [(frames[sched[j][0] - 1], a0 + sched[j][0], a0 + sched[j][1],
                          a0 + sched[j][2], sched[j][3], sched[j][4:6]) for j in lvl]
                results.update(zip(lvl, self._code_b_level(items, qp)))
            else:
                results[i] = self._code_b(frames[off - 1], poc, a0 + l0, a0 + l1, layer,
                                          (neg, pos), qp)
        # emission stays in decode order; pruning replays the sequential
        # order (deletions only: the stream is unaffected)
        for (off, _, _, _, neg, pos) in sched:
            self._prune_dpb(a0 + off, (neg, pos))
        self._anchor_poc = a0 + self.gop_size
        return [results[i] for i in range(len(sched))]
