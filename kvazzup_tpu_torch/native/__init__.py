"""Native host-runtime components (C, loaded via ctypes).

Built on first use into the package's `build/` directory (the generated
`cabac_tables.h` and `libslice_cabac.so`), rebuilt when the C source is
newer than the library.  `get_lib` raises if the library cannot be built or
loaded: the encoder never drops to the Python CABAC tier on its own.

Portability: the library is Linux-only — deblock_sao_c uses
pthread_barrier_t, which is optional POSIX and absent on Darwin.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_LOCK = threading.Lock()
_LIB = None


def _build() -> str:
    from .gen_tables import generate

    header = os.path.join(BUILD_DIR, "cabac_tables.h")
    src = os.path.join(_DIR, "slice_cabac.c")
    so = os.path.join(BUILD_DIR, "libslice_cabac.so")
    if (
        os.path.exists(so)
        and os.path.getmtime(so) > os.path.getmtime(src)
        and os.path.exists(header)
    ):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # concurrent builds (test workers) each write their own temporaries
    # and move them into place, so no process loads a half-written file
    tmp = f".{os.getpid()}.tmp"
    generate(header + tmp)
    os.replace(header + tmp, header)
    # -march=native is safe: the .so is gitignored and always built on
    # the machine that runs it (mtime-gated above).  Fall back to plain
    # -O2 if the toolchain rejects the flags.
    cmd = ["gcc", "-O3", "-march=native", "-funroll-loops", "-shared",
           "-fPIC", "-I", BUILD_DIR, src, "-o", so + tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, cwd=_DIR)
    except subprocess.CalledProcessError:
        cmd = ["gcc", "-O2", "-shared", "-fPIC", "-I", BUILD_DIR, src, "-o", so + tmp]
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=_DIR)
        if res.returncode != 0:
            raise RuntimeError(f"building {so} failed:\n{res.stderr}")
    os.replace(so + tmp, so)
    return so


def get_lib():
    """Load the native library, building it on first use.  Raises if it
    cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            lib.encode_slice_data_intra_c.restype = ctypes.c_long
            lib.encode_slice_data_intra_c.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.decode_slice_data_intra_c.restype = ctypes.c_int
            lib.decode_slice_data_intra_c.argtypes = [
                ctypes.c_void_p, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.encode_slice_data_intra_cu8_c.restype = ctypes.c_long
            lib.encode_slice_data_intra_cu8_c.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.decode_slice_data_intra_cu8_c.restype = ctypes.c_int
            lib.decode_slice_data_intra_cu8_c.argtypes = [
                ctypes.c_void_p, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _LIB = lib
    return _LIB


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def encode_slice_data_intra_native(cfg, modes, lev_y, lev_cb, lev_cr,
                                   slice_qp=None) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    sq = cfg.qp if slice_qp is None else slice_qp
    nctu = len(modes)
    modes = _as_i32(modes)
    lev_y = _as_i32(lev_y)
    lev_cb = _as_i32(lev_cb)
    lev_cr = _as_i32(lev_cr)
    cap = max(65536, lev_y.nbytes + lev_cb.nbytes + lev_cr.nbytes + 4096)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.encode_slice_data_intra_c(
        modes.ctypes.data, lev_y.ctypes.data, lev_cb.ctypes.data, lev_cr.ctypes.data,
        nctu, cfg.ctbs_w, cfg.ctb_log2, int(cfg.ctb_log2 == cfg.min_cb_log2), sq,
        out.ctypes.data, cap,
    )
    if n < 0:
        raise RuntimeError(f"native slice encode failed: {n}")
    return out[:n].tobytes()


def decode_slice_data_intra_native(cfg, payload: bytes, slice_qp: int):
    lib = get_lib()
    if lib is None:
        return None
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    modes = np.zeros(nctu, dtype=np.int32)
    lev_y = np.zeros((nctu, n, n), dtype=np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), dtype=np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), dtype=np.int32)
    buf = np.frombuffer(payload, dtype=np.uint8)
    rc = lib.decode_slice_data_intra_c(
        buf.ctypes.data, len(payload),
        nctu, cfg.ctbs_w, cfg.ctb_log2, int(cfg.ctb_log2 == cfg.min_cb_log2), slice_qp,
        modes.ctypes.data, lev_y.ctypes.data, lev_cb.ctypes.data, lev_cr.ctypes.data,
    )
    if rc != 0:
        raise ValueError(f"native slice decode failed: {rc}")
    return modes, lev_y, lev_cb, lev_cr


def _bind_unified(lib):
    import ctypes

    if hasattr(lib, "_unified_bound"):
        return
    lib.encode_slice_c.restype = ctypes.c_long
    lib.encode_slice_c.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.decode_slice_c.restype = ctypes.c_int
    lib.decode_slice_c.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib._unified_bound = True


def encode_slice_native(cfg, slice_type, wpp, arrays, slice_qp):
    """Unified native slice encoder.

    arrays: dict with keys (I) modes, lev_y, lev_cb, lev_cr or (P) ctype,
    intra_modes, mvs, mvp_flags, mvds, lev_y, lev_cb, lev_cr.
    Returns (payload bytes, entry_offsets list or None), or None if the
    native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    _bind_unified(lib)
    z = np.zeros(1, np.int32)
    if slice_type == 2:
        ctype = None
        modes = _as_i32(arrays["modes"])
        mvs = mvp = mvd = z
    else:
        ctype = _as_i32(arrays["ctype"])
        modes = _as_i32(arrays["intra_modes"])
        mvs = _as_i32(arrays["mvs"])
        mvp = _as_i32(arrays["mvp_flags"])
        mvd = _as_i32(arrays["mvds"])
    lev_y = _as_i32(arrays["lev_y"])
    lev_cb = _as_i32(arrays["lev_cb"])
    lev_cr = _as_i32(arrays["lev_cr"])
    cap = max(1 << 16, lev_y.nbytes + lev_cb.nbytes + lev_cr.nbytes + 4096 * max(1, cfg.ctbs_h))
    out = np.empty(cap, np.uint8)
    row_lens = np.zeros(max(1, cfg.ctbs_h), np.int64)
    merge_k = int(arrays.get("merge_k", 1) or 1)
    merge_idxs = arrays.get("merge_idxs")
    if merge_idxs is not None:
        merge_idxs = _as_i32(merge_idxs)
    n = lib.encode_slice_c(
        slice_type, 1 if wpp else 0,
        None if ctype is None else ctype.ctypes.data,
        modes.ctypes.data, mvs.ctypes.data, mvp.ctypes.data, mvd.ctypes.data,
        lev_y.ctypes.data, lev_cb.ctypes.data, lev_cr.ctypes.data,
        cfg.ctbs_w, cfg.ctbs_h, cfg.ctb_log2, int(cfg.ctb_log2 == cfg.min_cb_log2),
        slice_qp, out.ctypes.data, cap, row_lens.ctypes.data,
        None if merge_idxs is None else merge_idxs.ctypes.data,
        min(max(merge_k, 1), 5),
    )
    if n < 0:
        raise RuntimeError(f"native slice encode failed: {n}")
    entry = [int(x) for x in row_lens[: cfg.ctbs_h - 1]] if wpp else None
    return out[:n].tobytes(), entry


def decode_slice_native(cfg, slice_type, wpp, payload, entry_offsets, slice_qp,
                        merge_k: int = 1, col=None):
    """Unified native slice decoder; returns arrays dict or None."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_unified(lib)
    nctu = cfg.ctbs_w * cfg.ctbs_h
    n = cfg.ctb_size
    ctype = np.zeros(nctu, np.int32)
    modes = np.zeros(nctu, np.int32)
    mvs = np.zeros((nctu, 2), np.int32)
    lev_y = np.zeros((nctu, n, n), np.int32)
    lev_cb = np.zeros((nctu, n // 2, n // 2), np.int32)
    lev_cr = np.zeros((nctu, n // 2, n // 2), np.int32)
    buf = np.frombuffer(payload, np.uint8)
    offs = np.asarray(entry_offsets or [], np.int64)
    col_mv = col_inter = None
    if col is not None:
        col_mv = np.ascontiguousarray(np.asarray(col[0], np.int32))
        col_inter = np.ascontiguousarray(np.asarray(col[1], np.uint8))
    rc = lib.decode_slice_c(
        slice_type, 1 if wpp else 0,
        buf.ctypes.data, len(payload), offs.ctypes.data if len(offs) else None,
        cfg.ctbs_w, cfg.ctbs_h, cfg.ctb_log2, int(cfg.ctb_log2 == cfg.min_cb_log2),
        slice_qp,
        ctype.ctypes.data, modes.ctypes.data, mvs.ctypes.data,
        lev_y.ctypes.data, lev_cb.ctypes.data, lev_cr.ctypes.data,
        min(max(int(merge_k or 1), 1), 5),
        None if col_mv is None else col_mv.ctypes.data,
        None if col_inter is None else col_inter.ctypes.data,
    )
    if rc != 0:
        raise ValueError(f"native slice decode failed: {rc}")
    return dict(ctype=ctype, intra_modes=modes, mvs=mvs, lev_y=lev_y, lev_cb=lev_cb, lev_cr=lev_cr)


def encode_slice_data_intra_cu8_native(cfg, split, modes8, lev_y, lev_cb, lev_cr,
                                       slice_qp) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    nctu = len(split)
    split = _as_i32(split)
    modes8 = _as_i32(modes8)
    lev_y = _as_i32(lev_y)
    lev_cb = _as_i32(lev_cb)
    lev_cr = _as_i32(lev_cr)
    cap = max(65536, lev_y.nbytes + lev_cb.nbytes + lev_cr.nbytes + 4096)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.encode_slice_data_intra_cu8_c(
        split.ctypes.data, modes8.ctypes.data,
        lev_y.ctypes.data, lev_cb.ctypes.data, lev_cr.ctypes.data,
        nctu, cfg.ctbs_w, slice_qp, out.ctypes.data, cap,
    )
    if n < 0:
        raise RuntimeError(f"native cu8 slice encode failed: {n}")
    return out[:n].tobytes()


def decode_slice_data_intra_cu8_native(cfg, payload: bytes, slice_qp: int):
    lib = get_lib()
    if lib is None:
        return None
    nctu = cfg.ctbs_w * cfg.ctbs_h
    split = np.zeros(nctu, np.int32)
    modes8 = np.zeros((nctu, 4), np.int32)
    lev_y = np.zeros((nctu, 16, 16), np.int32)
    lev_cb = np.zeros((nctu, 8, 8), np.int32)
    lev_cr = np.zeros((nctu, 8, 8), np.int32)
    buf = np.frombuffer(payload, np.uint8)
    rc = lib.decode_slice_data_intra_cu8_c(
        buf.ctypes.data, len(payload), nctu, cfg.ctbs_w, slice_qp,
        split.ctypes.data, modes8.ctypes.data,
        lev_y.ctypes.data, lev_cb.ctypes.data, lev_cr.ctypes.data,
    )
    if rc != 0:
        raise ValueError(f"native cu8 slice decode failed: {rc}")
    return split, modes8, lev_y, lev_cb, lev_cr


# ---------------------------------------------------------------- generic
# quadtree parser (openHEVC-replacement decode path): C CABAC parse of a
# full generic slice segment into a replay record consumed by
# decoder/replay.ReplayDecoder — the Python generic tier's decode logic
# runs unchanged with zero CABAC math.

def _bind_generic(lib):
    import ctypes

    if hasattr(lib, "_generic_bound"):
        return
    lib.recon_generic_slice_c.restype = ctypes.c_long
    lib.recon_generic_slice_c.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,                                   # rcfg
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # y u v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qp4 ev eh
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # inter4 mv4 ref4
        ctypes.c_void_p, ctypes.c_void_p,                   # refpoc4 cbf4
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pf4 mv4l rp4l
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # sao t a o
        ctypes.c_void_p, ctypes.c_void_p,                   # ref0 ptrs/poc
        ctypes.c_void_p, ctypes.c_void_p,                   # ref1 ptrs/poc
        ctypes.c_void_p,                                    # col ptrs
        ctypes.c_void_p,                                    # weights
    ]
    lib.recon_generic_wpp_c.restype = ctypes.c_long
    lib.recon_generic_wpp_c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,                                   # rcfg
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # y u v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qp4 ev eh
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # inter4 mv4 ref4
        ctypes.c_void_p, ctypes.c_void_p,                   # refpoc4 cbf4
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pf4 mv4l rp4l
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # sao t a o
        ctypes.c_void_p, ctypes.c_void_p,                   # ref0 ptrs/poc
        ctypes.c_void_p, ctypes.c_void_p,                   # ref1 ptrs/poc
        ctypes.c_void_p,                                    # col ptrs
        ctypes.c_void_p,                                    # weights
    ]
    lib.parse_generic_slice_c.restype = ctypes.c_long
    lib.parse_generic_slice_c.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p,
    ]
    lib._generic_bound = True


class GenericParseState:
    """Per-picture persistent state across slice-segment parse calls."""

    def __init__(self, w: int, h: int):
        from ..entropy.cabac_tables import NUM_CONTEXTS

        self.depth4 = np.zeros((h // 4) * (w // 4), np.int32)
        self.skip4 = np.zeros((h // 4) * (w // 4), np.int32)
        self.mode4 = np.ones((h // 4) * (w // 4), np.int32)
        self.ctx = np.zeros(2 * NUM_CONTEXTS, np.uint8)


def parse_generic_segment(cfgv, payload: bytes, init_type: int, slice_qp: int,
                          dependent: bool, ctb_from: int, ctb_to: int,
                          slice_of, cur_slice: int, state: GenericParseState,
                          npix: int, slice_last: int | None = None,
                          subset_term: bool = False, snap_after: int = -1,
                          ctx_snap=None):
    """Parse one slice segment; returns (bins, levs, meta, pcm) numpy
    arrays or None (native unavailable / parse error -> caller falls back
    to the pure-Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_generic(lib)
    buf = np.frombuffer(payload, np.uint8)
    bins = np.empty(16 * npix + 65536, np.uint8)
    levs = np.empty(2 * npix + 65536, np.int32)
    meta = np.empty(npix // 8 + 4096, np.int32)
    pcm = np.empty(3 * npix // 2 + 64, np.int32)
    out_lens = np.zeros(4, np.int64)
    so = None if slice_of is None else np.ascontiguousarray(slice_of, np.int32)
    if slice_last is None:
        slice_last = ctb_to - 1
    rc = lib.parse_generic_slice_c(
        buf.ctypes.data, len(payload), init_type, slice_qp,
        1 if dependent else 0, np.ascontiguousarray(cfgv, np.int32).ctypes.data,
        ctb_from, ctb_to,
        slice_last, 1 if subset_term else 0, snap_after,
        None if ctx_snap is None else ctx_snap.ctypes.data,
        None if so is None else so.ctypes.data, cur_slice,
        state.depth4.ctypes.data, state.skip4.ctypes.data,
        state.mode4.ctypes.data, state.ctx.ctypes.data,
        bins.ctypes.data, len(bins),
        levs.ctypes.data, len(levs),
        meta.ctypes.data, len(meta),
        pcm.ctypes.data, len(pcm),
        out_lens.ctypes.data,
    )
    if rc != 0:
        if os.environ.get("KVZ_TPU_PARSE_DEBUG"):
            import sys

            print(f"[native-parse] rc={rc} ctb[{ctb_from},{ctb_to}) "
                  f"len={len(payload)}", file=sys.stderr)
        return None
    nb, nl, nm, npc = (int(x) for x in out_lens)
    return bins[:nb], levs[:nl], meta[:nm], pcm[:npc]


def _ptr(a):
    return None if a is None else a.ctypes.data


def recon_generic_segment(cfgv, payload: bytes, init_type: int, slice_qp: int,
                          dependent: bool, ctb_from: int, ctb_to: int,
                          slice_of, cur_slice: int, state: GenericParseState,
                          rcfg, bufs: dict, refs, col_ptrs, wt,
                          slice_last: int | None = None,
                          subset_term: bool = False, snap_after: int = -1,
                          ctx_snap=None) -> bool:
    """Decode + reconstruct one slice segment natively into the decoder's
    buffers (bufs: y u v qp4 edge_v edge_h inter4 mv4 ref4 refpoc4 cbf4
    pf4 mv4l refpoc4l sao_typ sao_aux sao_offs as numpy arrays or None).
    refs = (ref0_ptrs, ref0_poc, ref1_ptrs, ref1_poc) int64/int32 arrays or
    Nones.  Returns True, or False on a native parse error (caller falls
    back to the Python path)."""
    lib = get_lib()
    if lib is None:
        return False
    _bind_generic(lib)
    buf = np.frombuffer(payload, np.uint8)
    if slice_last is None:
        slice_last = ctb_to - 1
    so = None if slice_of is None else np.ascontiguousarray(slice_of, np.int32)
    r0p, r0poc, r1p, r1poc = refs
    rc = lib.recon_generic_slice_c(
        buf.ctypes.data, len(payload), init_type, slice_qp,
        1 if dependent else 0,
        np.ascontiguousarray(cfgv, np.int32).ctypes.data,
        ctb_from, ctb_to,
        slice_last, 1 if subset_term else 0, snap_after,
        None if ctx_snap is None else ctx_snap.ctypes.data,
        None if so is None else so.ctypes.data, cur_slice,
        state.depth4.ctypes.data, state.skip4.ctypes.data,
        state.mode4.ctypes.data, state.ctx.ctypes.data,
        rcfg.ctypes.data,
        _ptr(bufs["y"]), _ptr(bufs["u"]), _ptr(bufs["v"]),
        _ptr(bufs["qp4"]), _ptr(bufs["edge_v"]), _ptr(bufs["edge_h"]),
        _ptr(bufs["inter4"]), _ptr(bufs["mv4"]), _ptr(bufs["ref4"]),
        _ptr(bufs["refpoc4"]), _ptr(bufs["cbf4"]),
        _ptr(bufs["pf4"]), _ptr(bufs["mv4l"]), _ptr(bufs["refpoc4l"]),
        _ptr(bufs["sao_typ"]), _ptr(bufs["sao_aux"]), _ptr(bufs["sao_offs"]),
        _ptr(r0p), _ptr(r0poc), _ptr(r1p), _ptr(r1poc),
        _ptr(col_ptrs), _ptr(wt),
    )
    if rc != 0:
        if os.environ.get("KVZ_TPU_PARSE_DEBUG"):
            import sys

            print(f"[native-recon] rc={rc} ctb[{ctb_from},{ctb_to}) "
                  f"len={len(payload)}", file=sys.stderr)
        return False
    return True


def recon_generic_wpp(cfgv, payload: bytes, bounds, nthreads: int,
                      init_type: int, slice_qp: int,
                      ctb_from: int, ctb_to: int,
                      slice_of, cur_slice: int, state: GenericParseState,
                      rcfg, bufs: dict, refs, col_ptrs, wt) -> bool:
    """Decode + reconstruct one WPP slice (all row substreams) natively
    with row-parallel wavefront threads (skew-2 sync + 9.3.2.3 context
    inheritance in C).  bounds: int list of row substream byte offsets
    (len nrows+1).  Same buffer contract as recon_generic_segment."""
    lib = get_lib()
    if lib is None:
        return False
    _bind_generic(lib)
    buf = np.frombuffer(payload, np.uint8)
    bnd = np.ascontiguousarray(bounds, np.int64)
    nrows = len(bnd) - 1
    so = None if slice_of is None else np.ascontiguousarray(slice_of, np.int32)
    r0p, r0poc, r1p, r1poc = refs
    rc = lib.recon_generic_wpp_c(
        buf.ctypes.data, bnd.ctypes.data, nrows, nthreads,
        init_type, slice_qp,
        np.ascontiguousarray(cfgv, np.int32).ctypes.data,
        ctb_from, ctb_to, ctb_to - 1,
        None if so is None else so.ctypes.data, cur_slice,
        state.depth4.ctypes.data, state.skip4.ctypes.data,
        state.mode4.ctypes.data,
        rcfg.ctypes.data,
        _ptr(bufs["y"]), _ptr(bufs["u"]), _ptr(bufs["v"]),
        _ptr(bufs["qp4"]), _ptr(bufs["edge_v"]), _ptr(bufs["edge_h"]),
        _ptr(bufs["inter4"]), _ptr(bufs["mv4"]), _ptr(bufs["ref4"]),
        _ptr(bufs["refpoc4"]), _ptr(bufs["cbf4"]),
        _ptr(bufs["pf4"]), _ptr(bufs["mv4l"]), _ptr(bufs["refpoc4l"]),
        _ptr(bufs["sao_typ"]), _ptr(bufs["sao_aux"]), _ptr(bufs["sao_offs"]),
        _ptr(r0p), _ptr(r0poc), _ptr(r1p), _ptr(r1poc),
        _ptr(col_ptrs), _ptr(wt),
    )
    if rc != 0:
        if os.environ.get("KVZ_TPU_PARSE_DEBUG"):
            import sys

            print(f"[native-recon-wpp] rc={rc} ctb[{ctb_from},{ctb_to}) "
                  f"rows={nrows}", file=sys.stderr)
        return False
    return True


def native_bs_maps(gd, is_b: bool):
    """Deblock boundary strengths from the decoder's 4x4 maps in C
    (bs_maps_c), or None to use the Python gd.bs_maps().  Pure function
    of the maps, so it serves every decode tier."""
    lib = get_lib()
    if lib is None:
        return None
    h4, w4 = gd.inter4.shape
    h8, w8 = gd.edge_v.shape
    if h4 != 2 * h8 or w4 != 2 * w8:
        return None  # partial 8-grid geometry: keep the Python reference
    if not hasattr(lib, "_bs_bound"):
        lib.bs_maps_c.restype = None
        lib.bs_maps_c.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 11
        lib._bs_bound = True
    bs_v = np.zeros((w8 - 1, h4), np.int32)
    bs_h = np.zeros((h8 - 1, w4), np.int32)
    args = [gd.inter4, gd.cbf4, gd.edge_v, gd.edge_h, gd.mv4, gd.refpoc4]
    if is_b:
        args += [gd.pf4, gd.mv4l, gd.refpoc4l]
    else:
        args += [None, None, None]
    for a in args:
        if a is not None and not a.flags.c_contiguous:
            return None
    lib.bs_maps_c(
        1 if is_b else 0, w4, h4, w8, h8,
        *[None if a is None else a.ctypes.data for a in args],
        bs_v.ctypes.data, bs_h.ctypes.data)
    return bs_v, bs_h


def _filter_threads() -> int:
    """Worker count for the threaded in-loop filter pass (deblock_sao_c);
    1 runs it inline.  KVZ_TPU_FILTER_THREADS overrides."""
    raw = os.environ.get("KVZ_TPU_FILTER_THREADS")
    if raw is not None:
        try:
            return max(1, int(raw))
        except ValueError:
            raise ValueError(
                f"KVZ_TPU_FILTER_THREADS must be an int, got {raw!r}")
    return min(4, os.cpu_count() or 1)


def native_filters(gd, sps, pps, sh, sao_state):
    """In-loop filters in C (deblock_sao_c) for the generic decode tier:
    deblock (spacing 8, 4-sample bS segments) then SAO, byte-identical to
    ops/deblock.deblock_frame + ops/sao.sao_apply.  Returns (y, u, v)
    uint8 numpy planes, or None to use the JAX reference path.  Callers
    gate bd == 8 and the slice-restricted filter cases."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = gd.w, gd.h
    if w % 8 or h % 8:
        return None
    h4, w4 = h // 4, w // 4
    h8, w8 = h // 8, w // 8
    do_deblock = 0 if pps.deblocking_disabled else 1
    if do_deblock:
        if hasattr(gd, "bs_maps"):
            bs = native_bs_maps(gd, is_b=hasattr(gd, "pf4"))
            if bs is None:
                bs = gd.bs_maps()
            bs_v, bs_h = (np.ascontiguousarray(b, np.int32) for b in bs)
            if bs_v.shape != (w8 - 1, h4) or bs_h.shape != (h8 - 1, w4):
                return None
        else:
            # all-intra: every recorded CU/TU edge is bS 2, 4-granular
            bs_v = np.repeat(
                2 * gd.edge_v.T[1:].astype(np.int32), 2, axis=1)
            bs_h = np.repeat(
                2 * gd.edge_h[1:].astype(np.int32), 2, axis=1)
        qp_map8 = None
        if gd.cu_qp_delta:
            qp_map8 = np.ascontiguousarray(gd.qp4[::2, ::2], np.int32)
    else:
        bs_v = bs_h = qp_map8 = None
    if not hasattr(lib, "_filters_bound"):
        lib.deblock_sao_c.restype = None
        lib.deblock_sao_c.argtypes = [ctypes.c_int] * 12 + [ctypes.c_void_p] * 12
        lib._filters_bound = True
    sao_luma = 1 if (sao_state is not None and sao_state.luma) else 0
    sao_chroma = 1 if (sao_state is not None and sao_state.chroma) else 0
    oy = np.empty((h, w), np.uint8)
    ou = np.empty((h // 2, w // 2), np.uint8)
    ov = np.empty((h // 2, w // 2), np.uint8)
    lib.deblock_sao_c(
        w, h, sps.ctb_log2,
        sh.qp, sh.beta_offset_div2, sh.tc_offset_div2, gd.cb_off, gd.cr_off,
        do_deblock, sao_luma, sao_chroma,
        _filter_threads(),
        gd.y.ctypes.data, gd.u.ctypes.data, gd.v.ctypes.data,
        _ptr(bs_v), _ptr(bs_h), _ptr(qp_map8),
        None if sao_state is None else sao_state.typ.ctypes.data,
        None if sao_state is None else sao_state.aux.ctypes.data,
        None if sao_state is None else sao_state.offs.ctypes.data,
        oy.ctypes.data, ou.ctypes.data, ov.ctypes.data)
    return oy, ou, ov


def _bind_quad(lib):
    import ctypes

    if hasattr(lib, "_quad_bound"):
        return
    lib.encode_slice_quad_c.restype = ctypes.c_long
    lib.encode_slice_quad_c.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
    ]
    lib._quad_bound = True


def encode_slice_quad_native(cfg, slice_type, wpp, tokens, levels, slice_qp,
                             sao=None, qp_map=None, merge_k: int = 1):
    """Native CU-quadtree slice writer (the entropy/quad.py twin).

    tokens/levels: the serialized tree stream (entropy/quad._serialize).
    sao: a SaoState (its typ/aux/offs arrays ride directly) or None.
    Returns (payload bytes, entry_offsets list or None), or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_quad(lib)
    tokens = _as_i32(tokens)
    levels = _as_i32(levels)
    sao_t = sao_a = sao_o = None
    if sao is not None:
        sao_t = _as_i32(sao.typ)
        sao_a = _as_i32(sao.aux)
        sao_o = _as_i32(sao.offs)
    qpm = None if qp_map is None else np.ascontiguousarray(
        np.asarray(qp_map, np.int32).reshape(-1))
    cap = max(1 << 16, levels.nbytes + 4096 * max(1, cfg.ctbs_h))
    out = np.empty(cap, np.uint8)
    row_lens = np.zeros(max(1, cfg.ctbs_h), np.int64)
    n = lib.encode_slice_quad_c(
        slice_type, 1 if wpp else 0,
        tokens.ctypes.data, levels.ctypes.data,
        cfg.ctbs_w, cfg.ctbs_h, cfg.ctb_log2, cfg.min_cb_log2,
        cfg.max_transform_hierarchy_depth_intra,
        slice_qp, merge_k,
        None if sao_t is None else sao_t.ctypes.data,
        None if sao_a is None else sao_a.ctypes.data,
        None if sao_o is None else sao_o.ctypes.data,
        None if qpm is None else qpm.ctypes.data,
        out.ctypes.data, cap, row_lens.ctypes.data,
    )
    if n < 0:
        return None
    payload = bytes(out[:n])
    if wpp:
        return payload, [int(x) for x in row_lens[: cfg.ctbs_h - 1]]
    return payload, None
