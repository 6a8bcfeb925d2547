"""NAL unit framing: headers, Annex-B byte-stream mux/demux.

Reference parity: kvazaar `nal.c` (Bitstream group) and the NAL-type gating
the reference app performs at uvgComm src/media/processing/
openhevcfilter.cpp:116-143 (waits for VPS/SPS/PPS before decode).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from .bitstream import (
    insert_emulation_prevention,
    remove_emulation_prevention,
    remove_emulation_prevention_pos,
)


class NalType(IntEnum):
    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS = 32
    SPS = 33
    PPS = 34
    AUD = 35
    EOS = 36
    EOB = 37
    FD = 38
    PREFIX_SEI = 39
    SUFFIX_SEI = 40


def is_irap(t: int) -> bool:
    return 16 <= t <= 23


def is_idr(t: int) -> bool:
    return t in (NalType.IDR_W_RADL, NalType.IDR_N_LP)


@dataclass
class NalUnit:
    nal_type: int
    rbsp: bytes
    layer_id: int = 0
    temporal_id_plus1: int = 1
    # RBSP offsets where an emulation-prevention byte was removed (only
    # populated by split_annexb; used to map entry_point_offsets)
    removals: tuple = ()


def compose_nal(nal: NalUnit, long_start_code: bool = True) -> bytes:
    """NAL unit -> Annex-B bytes (start code + 2-byte header + payload)."""
    header = bytes(
        [
            (0 << 7) | (int(nal.nal_type) << 1) | (nal.layer_id >> 5),
            ((nal.layer_id & 0x1F) << 3) | nal.temporal_id_plus1,
        ]
    )
    payload = insert_emulation_prevention(nal.rbsp)
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + header + payload


def split_annexb(stream: bytes) -> list[NalUnit]:
    """Annex-B byte stream -> list of NAL units (emulation removed)."""
    units: list[NalUnit] = []
    i = 0
    n = len(stream)
    # find first start code
    starts: list[int] = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # previous start code may have been 00 00 00 01: payload end trims
        while e > s and stream[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        raw = stream[s:e]
        if len(raw) < 2:
            continue
        nal_type = (raw[0] >> 1) & 0x3F
        layer_id = ((raw[0] & 1) << 5) | (raw[1] >> 3)
        tid1 = raw[1] & 7
        rbsp, removals = remove_emulation_prevention_pos(raw[2:])
        units.append(NalUnit(nal_type, rbsp, layer_id, tid1, removals))
    return units


def rbsp_entry_offsets(removals, data_off: int, ebsp_offsets):
    """Map slice-header entry point offsets to the RBSP domain.

    entry_point_offset_minus1 counts bytes INCLUDING emulation-prevention
    bytes (7.4.7.1); our CABAC substream decoding slices the RBSP, so each
    boundary must be shifted left by the number of 0x03 bytes removed
    before it.  `removals` are RBSP offsets of dropped bytes (relative to
    the NAL payload start); data_off is the slice-data start in RBSP."""
    import bisect

    def to_ebsp(r):
        return r + bisect.bisect_right(removals, r)

    def to_rbsp(e):
        lo, hi = max(0, e - len(removals)), e
        while lo < hi:
            mid = (lo + hi) // 2
            if to_ebsp(mid) < e:
                lo = mid + 1
            else:
                hi = mid
        return lo

    acc = to_ebsp(data_off)
    out = []
    prev_r = data_off
    for off in ebsp_offsets:
        acc += off
        r = to_rbsp(acc)
        out.append(r - prev_r)
        prev_r = r
    return out


def ebsp_entry_offsets(payload: bytes, rbsp_lengths) -> list:
    """Per-substream byte lengths AFTER emulation-prevention insertion
    (7.4.7.1), with the zero-run carried across substream boundaries; the
    inverse of rbsp_entry_offsets for the encoder's slice-header mux."""
    out = []
    zeros = 0
    pos = 0
    for length in rbsp_lengths:
        chunk = payload[pos : pos + length]
        pos += length
        n = length
        for b in chunk:
            if zeros >= 2 and b <= 3:
                n += 1
                zeros = 0
            zeros = zeros + 1 if b == 0 else 0
        out.append(n)
    return out
