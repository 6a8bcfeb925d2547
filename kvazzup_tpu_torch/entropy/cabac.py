"""CABAC arithmetic coding engine (ITU-T H.265 9.3.4), encode + decode.

Host-serial by nature: this is the one part of HEVC that is inherently
bit-sequential (the "hard serial part" — SURVEY.md §7).  The engine below is
the reference Python implementation; a C++ mirror (kvazzup_tpu/native) serves
the production path.  Per-WPP-row/tile engines run independently with
inherited context state, which is how the serial bottleneck is parallelized
across shards.

Counterpart: kvazaar CABAC group (`bitstream.c`, `cabac.c`, `context.c`).
"""

from __future__ import annotations

import numpy as np

from .cabac_tables import RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS, init_all_contexts


class CabacEncoder:
    """Binary arithmetic encoder producing a byte-aligned slice-data payload."""

    def __init__(self, init_type: int, slice_qp: int, ctx=None) -> None:
        # ctx: carried context table (dependent slice segments, 9.3.1 —
        # the arithmetic engine restarts, the contexts continue)
        self.ctx = init_all_contexts(init_type, slice_qp) if ctx is None else ctx.copy()
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self._bitbuf: list[int] = []
        self.bins_coded = 0

    # -- bit plumbing -----------------------------------------------------

    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self._bitbuf.append(b)
        if self.bits_outstanding:
            self._bitbuf.extend([1 - b] * self.bits_outstanding)
            self.bits_outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- bin coding -------------------------------------------------------

    def encode_bin(self, ctx_idx: int, bin_val: int) -> None:
        state, mps = self.ctx[ctx_idx]
        lps = int(RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if bin_val != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                self.ctx[ctx_idx, 1] = 1 - mps
            self.ctx[ctx_idx, 0] = TRANS_IDX_LPS[state]
        else:
            self.ctx[ctx_idx, 0] = TRANS_IDX_MPS[state]
        self._renorm()
        self.bins_coded += 1

    def encode_bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1
        self.bins_coded += 1

    def encode_bypass_bits(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self._flush()
        else:
            self._renorm()
        self.bins_coded += 1

    def _flush(self) -> None:
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # WriteBits(((ivlLow >> 7) & 3) | 1, 2) — includes the rbsp stop bit
        self._bitbuf.append((self.low >> 8) & 1)
        self._bitbuf.append(1)

    def data(self) -> bytes:
        """Byte-aligned payload (zero-padded); call after encode_terminate(1)."""
        bits = list(self._bitbuf)
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


class CabacDecoder:
    """Binary arithmetic decoder over a byte-aligned slice-data payload."""

    def __init__(self, data: bytes, init_type: int, slice_qp: int, ctx=None) -> None:
        self.ctx = init_all_contexts(init_type, slice_qp) if ctx is None else ctx.copy()
        self._data = data
        self._bitpos = 0
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bit(self) -> int:
        if self._bitpos >= len(self._data) * 8:
            return 0  # past end: conformant streams never rely on this
        byte = self._data[self._bitpos >> 3]
        b = (byte >> (7 - (self._bitpos & 7))) & 1
        self._bitpos += 1
        return b

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._read_bit()
        return v

    def decode_bin(self, ctx_idx: int) -> int:
        state, mps = self.ctx[ctx_idx]
        lps = int(RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - mps
            self.offset -= self.range
            self.range = lps
            if state == 0:
                self.ctx[ctx_idx, 1] = 1 - mps
            self.ctx[ctx_idx, 0] = TRANS_IDX_LPS[state]
        else:
            bin_val = int(mps)
            self.ctx[ctx_idx, 0] = TRANS_IDX_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def read_pcm_samples(self, counts_and_bits):
        """After pcm_flag == 1 (decode_terminate): byte-align, read raw
        fixed-length pcm_sample values, re-initialize the arithmetic
        engine (9.3.1/9.3.2.5 — contexts persist).

        counts_and_bits: [(n_values, bits_per_value), ...] in stream order.
        Returns list of int lists.  The byte position after a terminating
        bin is ceil(bits_read / 8) for this engine (verified against the
        encoder flush over randomized streams)."""
        self._bitpos = ((self._bitpos + 7) // 8) * 8
        out = []
        for count, bits in counts_and_bits:
            out.append([self._read_bits(bits) for _ in range(count)])
        # re-init engine at the next byte boundary, keep contexts
        self._bitpos = ((self._bitpos + 7) // 8) * 8
        self.range = 510
        self.offset = self._read_bits(9)
        return out


# ------------------------------------------------------------ binarizations


def encode_tr_prefix(enc: CabacEncoder, value: int, cmax: int, ctx_of_bin) -> None:
    """Truncated-unary prefix, context-coded: bins of 1s then terminating 0."""
    for i in range(value):
        enc.encode_bin(ctx_of_bin(i), 1)
    if value < cmax:
        enc.encode_bin(ctx_of_bin(value), 0)


def decode_tr_prefix(dec: CabacDecoder, cmax: int, ctx_of_bin) -> int:
    v = 0
    while v < cmax and dec.decode_bin(ctx_of_bin(v)):
        v += 1
    return v


def encode_coeff_remaining(enc: CabacEncoder, value: int, rice: int) -> None:
    """coeff_abs_level_remaining binarization (9.3.3.13): TR(4<<r) + EG(r+1)."""
    q = value >> rice
    if q < 4:
        enc.encode_bypass_bits((1 << (q + 1)) - 2, q + 1)  # q ones + zero
        if rice:
            enc.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        v = value - (4 << rice)
        c = 0
        while v >= (1 << (rice + 1 + c)):
            v -= 1 << (rice + 1 + c)
            c += 1
        # prefix: 4+c ones then zero; suffix: rice+1+c bits
        n_ones = 4 + c
        enc.encode_bypass_bits(((1 << n_ones) - 1) << 1, n_ones + 1)
        enc.encode_bypass_bits(v, rice + 1 + c)


def decode_coeff_remaining(dec: CabacDecoder, rice: int) -> int:
    prefix = 0
    while prefix < 32 and dec.decode_bypass():
        prefix += 1
    if prefix < 4:
        return (prefix << rice) + (dec.decode_bypass_bits(rice) if rice else 0)
    c = prefix - 4
    base = (4 << rice) + (((1 << c) - 1) << (rice + 1))
    return base + dec.decode_bypass_bits(rice + 1 + c)
