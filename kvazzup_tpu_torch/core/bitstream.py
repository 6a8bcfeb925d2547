"""Host-side bit-level I/O for HEVC headers and NAL payloads.

This is the writer/reader for everything *outside* CABAC: NAL headers,
parameter sets (Exp-Golomb ue(v)/se(v), fixed-width u(n)), slice headers,
and Annex-B byte-stream framing with emulation prevention.

Counterpart in the reference: kvazaar's `Bitstream` group
(dependencies/kvazaar_CMakeLists.txt:207 "Bitstream": encoder_state-bitstream,
nal) — re-implemented from the H.265 spec, host-side, as the serial edge of
the TPU pipeline.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP byte string."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0  # bits currently in _cur (0..7)

    def u(self, value: int, nbits: int) -> None:
        """Write `value` as an unsigned fixed-width field of `nbits` bits."""
        if nbits < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        for i in range(nbits - 1, -1, -1):
            self._cur = (self._cur << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._cur)
                self._cur = 0
                self._nbits = 0

    def flag(self, value: int | bool) -> None:
        self.u(1 if value else 0, 1)

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (H.265 9.2)."""
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        code = value + 1
        nbits = code.bit_length()
        self.u(0, nbits - 1)
        self.u(code, nbits)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb: 0,1,-1,2,-2,... -> 0,1,2,3,4,..."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def bytes_aligned(self) -> bool:
        return self._nbits == 0

    def align_zero(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._nbits:
            self.u(0, 8 - self._nbits)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit followed by zero alignment."""
        self.flag(1)
        self.align_zero()

    def byte_alignment(self) -> None:
        """alignment_bit_equal_to_one + zeros (slice-header style alignment)."""
        self.flag(1)
        self.align_zero()

    def write_bytes(self, data: bytes) -> None:
        if self._nbits:
            raise ValueError("write_bytes requires byte alignment")
        self._bytes.extend(data)

    def num_bits(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def data(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte aligned; call align/trailing first")
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def flag(self) -> int:
        return self.u(1)

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("malformed ue(v)")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_alignment(self) -> None:
        one = self.u(1)
        if one != 1:
            raise ValueError("alignment bit is not 1")
        while self._pos & 7:
            self.u(1)

    def bit_pos(self) -> int:
        return self._pos

    def byte_pos(self) -> int:
        if self._pos & 7:
            raise ValueError("not byte aligned")
        return self._pos >> 3

    def remaining_bytes(self) -> bytes:
        return self._data[(self._pos + 7) >> 3 :]

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data left before the rbsp trailing bits."""
        nbits = len(self._data) * 8
        if self._pos >= nbits:
            return False
        # find last set bit in the stream (the rbsp_stop_one_bit)
        for bytepos in range(len(self._data) - 1, -1, -1):
            b = self._data[bytepos]
            if b:
                for bit in range(7, -1, -1):
                    if (b >> (7 - bit)) & 1:
                        pass
                # lowest set bit index (from MSB ordering)
                low = 0
                bb = b
                while bb & 1 == 0:
                    bb >>= 1
                    low += 1
                stop_bitpos = bytepos * 8 + (7 - low)
                return self._pos < stop_bitpos
        return False


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """RBSP -> NAL payload: insert 0x03 after any 0x0000 followed by
    0x00..0x03.

    Vectorized candidate detection (i >= 2 with rbsp[i] <= 3 and two
    preceding zero bytes) plus a tiny greedy pass for the reset rule: an
    insertion restarts the zero count, so a later candidate is valid only
    if its two zeros lie at or after the previous insertion point —
    equivalently, at distance >= 2 (e.g. 00 00 00 00 escapes once)."""
    import numpy as np

    if len(rbsp) < 3:
        return rbsp
    a = np.frombuffer(rbsp, np.uint8)
    cand = np.nonzero((a[2:] <= 3) & (a[1:-1] == 0) & (a[:-2] == 0))[0] + 2
    if cand.size == 0:
        return rbsp
    acc = []
    last = -2
    for c in cand.tolist():
        if c - last >= 2:
            acc.append(c)
            last = c
    return np.insert(a, acc, np.uint8(3)).tobytes()


def remove_emulation_prevention(payload: bytes) -> bytes:
    """NAL payload -> RBSP: strip emulation-prevention 0x03 bytes."""
    return remove_emulation_prevention_pos(payload)[0]


def remove_emulation_prevention_pos(payload: bytes) -> tuple:
    """As remove_emulation_prevention, but also return the RBSP offsets at
    which a 0x03 byte was dropped (needed to map the slice header's
    entry_point_offsets — which count emulation bytes, 7.4.7.1 — onto the
    RBSP payload).

    Vectorized: the byte-scan rule "drop 0x03 after two appended zeros"
    is equivalent to "drop payload[i] == 3 where payload[i-2:i] == 00 00",
    because zeros only accumulate over appended 0x00 input bytes (a drop
    resets the count and the dropped byte is 0x03, never 0x00), so the
    two qualifying zeros are always the two immediately preceding input
    bytes."""
    import numpy as np

    n = len(payload)
    if n < 3:
        return payload, ()
    a = np.frombuffer(payload, np.uint8)
    cand = np.nonzero((a[2:] == 3) & (a[1:-1] == 0) & (a[:-2] == 0))[0] + 2
    if cand.size == 0:
        return payload, ()
    keep = np.ones(n, bool)
    keep[cand] = False
    # RBSP offset of each drop = input index minus drops before it
    rem = cand - np.arange(cand.size)
    return a[keep].tobytes(), tuple(int(r) for r in rem)
