"""Wavefront (WPP-skew) schedule tables — static geometry shared by the
encoder and decoder scans.

The anti-diagonal d = 2r + c grouping is pure static geometry, so lane
coordinates, validity masks and the wave<->raster permutations are
precomputed numpy constants: per-wave inputs are pre-gathered with static
indices outside the scan, per-wave outputs ride `lax.scan`'s free output
stacking, and only the reconstruction (true sequential state) lives in the
carry.  This removes all dynamic-index traffic except the neighbor-block
gathers and the recon block scatter.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def schedule(cw: int, ch: int):
    """Static wavefront tables for a (cw x ch) CTU grid.

    Returns dict of numpy arrays:
      rs, cs:   (n_waves, lanes) lane coordinates (0 where invalid)
      valid:    (n_waves, lanes) bool
      idx:      (n_waves, lanes) raster CTU index (nctu where invalid)
      perm:     (nctu,) index into flattened (n_waves*lanes) wave order
    """
    lanes = min(ch, cw // 2 + 1)
    n_waves = 2 * ch + cw - 2
    nctu = cw * ch
    rs = np.zeros((n_waves, lanes), np.int32)
    cs = np.zeros((n_waves, lanes), np.int32)
    valid = np.zeros((n_waves, lanes), bool)
    idx = np.full((n_waves, lanes), nctu, np.int32)
    perm = np.zeros(nctu, np.int64)
    for d in range(n_waves):
        r_min = max(0, -(-(d - cw + 1) // 2))  # ceil((d-cw+1)/2)
        for k in range(lanes):
            r = r_min + k
            c = d - 2 * r
            if 0 <= r < ch and 0 <= c < cw:
                rs[d, k] = r
                cs[d, k] = c
                valid[d, k] = True
                i = r * cw + c
                idx[d, k] = i
                perm[i] = d * lanes + k
    assert valid.sum() == nctu
    return {"rs": rs, "cs": cs, "valid": valid, "idx": idx, "perm": perm,
            "lanes": lanes, "n_waves": n_waves}


@functools.lru_cache(maxsize=None)
def schedule_r(cw: int, ch: int):
    """Row-aligned wavefront tables: lane k ALWAYS holds CTU row r == k.

    Costs a few idle lanes vs the packed `schedule` (lanes == ch instead of
    min(ch, cw//2+1)) but makes every neighbor reference a STATIC lane
    shift: CTU (r, c) sits in wave d = 2r + c at lane r, so its left
    neighbor is lane r of wave d-1, above is lane r-1 of wave d-2,
    above-right lane r-1 of wave d-1 and above-left lane r-1 of wave d-3.
    A scan that carries only the last three waves' boundary samples (a
    "ring") then needs no dynamic gathers or scatters at all.
    """
    lanes = ch
    n_waves = 2 * ch + cw - 2
    nctu = cw * ch
    rs = np.broadcast_to(np.arange(ch, dtype=np.int32), (n_waves, lanes)).copy()
    ds = np.arange(n_waves, dtype=np.int32)[:, None]
    cs = ds - 2 * rs
    valid = (cs >= 0) & (cs < cw)
    idx = np.where(valid, rs * cw + np.clip(cs, 0, cw - 1), nctu).astype(np.int32)
    cs = np.where(valid, cs, 0).astype(np.int32)
    perm = np.zeros(nctu, np.int64)
    w, k = np.nonzero(valid)
    perm[idx[w, k]] = w * lanes + k
    return {"rs": rs, "cs": cs, "valid": valid, "idx": idx, "perm": perm,
            "lanes": lanes, "n_waves": n_waves}
