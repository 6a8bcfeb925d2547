"""Frame-pipelined encoder: the device stage of frame N+1 overlaps the
device-to-host fetch and the CABAC of frame N (counterpart of
kvazzup_tpu/encoder/pipelined.py, kvazaar's `--owf` open work frames).

Three stages, `depth` frames in flight:

1. device: `Encoder.encode_frame_device` on the caller's thread (its
   kernels are queued on the current CUDA stream), then a CUDA event
   recorded behind them;
2. fetch: one worker thread waits for that event on a stream of its own
   and copies the frame's outputs (levels and decisions, the SAO
   parameters and, with `materialize_recon`, the loop-filtered recon) into
   pinned host buffers, the levels as int8 when every |level| <= 127; it
   synchronises only its own stream, so it never waits for a later frame's
   device work;
3. entropy: one worker thread runs `Encoder.encode_frame_entropy` in
   frame order.

The native CABAC releases the interpreter lock while it codes, so it
overlaps the device stage; the Python CABAC tier (CTB16 with SAO) holds
it, and then slows the device stage's launch loop instead.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

from .top import Encoder


class PipelinedEncoder:
    """`Encoder`'s API made asynchronous: push() takes a frame and returns
    the (stream, recon) pairs finished so far, in order; flush() drains the
    rest.  `stage` accumulates the fetch and CABAC seconds, the bytes
    fetched and the frames coded."""

    def __init__(self, cfg, intra_period: int = 1, depth: int = 3,
                 materialize_recon: bool = True, *, device="cuda", vps_period: int = 0) -> None:
        self.enc = Encoder(cfg, intra_period=intra_period, device=device,
                           vps_period=vps_period)
        self.depth = max(1, depth)
        self.materialize_recon = materialize_recon
        self._cuda = self.enc.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.enc.device) if self._cuda else None
        self._fetch_pool = ThreadPoolExecutor(max_workers=1)
        self._pool = ThreadPoolExecutor(max_workers=1)  # in-order CABAC
        self._pending: deque = deque()
        # each stage is one worker thread, so plain accumulation is safe
        self.stage = {"fetch_s": 0.0, "fetch_bytes": 0, "cabac_s": 0.0, "frames": 0}

    def _to_host(self, tensors: dict, packed: set) -> dict:
        """{name: tensor} -> {name: numpy}, `packed` names as int8."""
        if not self._cuda:
            return {k: (v.to(torch.int8) if k in packed else v).numpy()
                    for k, v in tensors.items()}
        host = {}
        for k, v in tensors.items():
            v.record_stream(self._stream)  # its memory stays live until the copy ends
            src = v.to(torch.int8) if k in packed else v
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src, non_blocking=True)
            host[k] = buf
        self._stream.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def _fetch(self, ctx, ready):
        """The fetch stage: ctx with its tensors copied to the host."""
        t0 = time.monotonic()
        out = ctx["out"]
        tensors = {k: v for k, v in out.items()
                   if isinstance(v, torch.Tensor) and not k.startswith("recon")}
        if ctx["sao"] is not None:
            tensors.update((f"sao{i}", t) for i, t in enumerate(ctx["sao"]))
        if self.materialize_recon:
            tensors.update((f"recon{i}", t) for i, t in enumerate(ctx["recon"]))
        levs = [k for k in tensors if k.startswith("lev_")]
        with torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext():
            if self._cuda:
                self._stream.wait_event(ready)
            packed = set()
            # levels almost never pass |127| at streaming QPs: one scalar
            # decides, and int8 halves the largest copy
            if levs and int(torch.stack([tensors[k].abs().max() for k in levs]).max()) <= 127:
                packed = set(levs)
            host = self._to_host(tensors, packed)
        fetched = dict(ctx)
        fetched["out"] = {k: host.get(k, v) for k, v in out.items()
                          if not (isinstance(v, torch.Tensor) and k.startswith("recon"))}
        if ctx["sao"] is not None:
            fetched["sao"] = tuple(host[f"sao{i}"] for i in range(len(ctx["sao"])))
        if self.materialize_recon:
            fetched["recon"] = tuple(host[f"recon{i}"] for i in range(len(ctx["recon"])))
        self.stage["fetch_s"] += time.monotonic() - t0
        self.stage["fetch_bytes"] += sum(v.nbytes for v in host.values())
        return fetched

    def _entropy(self, fetched):
        ctx = fetched.result()
        t0 = time.monotonic()
        out = self.enc.encode_frame_entropy(ctx, self.materialize_recon)
        self.stage["cabac_s"] += time.monotonic() - t0
        self.stage["frames"] += 1
        return out

    def push(self, y, u, v, qp=None):
        ctx = self.enc.encode_frame_device(y, u, v, qp)
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record()
        fetched = self._fetch_pool.submit(self._fetch, ctx, ready)
        self._pending.append(self._pool.submit(self._entropy, fetched))
        done = []
        while self._pending and (len(self._pending) > self.depth or self._pending[0].done()):
            done.append(self._pending.popleft().result())
        return done

    def flush(self):
        out = [f.result() for f in self._pending]
        self._pending.clear()
        return out

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._fetch_pool.shutdown(wait=True)
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
