"""Raw YUV (I420) and Y4M file I/O.

Counterpart of the reference's capture/convert edge (libyuvconverter.cpp,
cameraformats.cpp) for the file-based CLI and the conformance runner.
"""

from __future__ import annotations

import re

import numpy as np


def read_yuv420(path: str, width: int, height: int, max_frames: int | None = None):
    """Read raw planar I420 frames -> list of (y, u, v) uint8 arrays."""
    ysz, csz = width * height, (width // 2) * (height // 2)
    frame_sz = ysz + 2 * csz
    frames = []
    with open(path, "rb") as f:
        while max_frames is None or len(frames) < max_frames:
            buf = f.read(frame_sz)
            if len(buf) < frame_sz:
                break
            arr = np.frombuffer(buf, dtype=np.uint8)
            yp = arr[:ysz].reshape(height, width)
            up = arr[ysz : ysz + csz].reshape(height // 2, width // 2)
            vp = arr[ysz + csz :].reshape(height // 2, width // 2)
            frames.append((yp, up, vp))
    return frames


def write_yuv420(path: str, frames) -> None:
    with open(path, "wb") as f:
        for y, u, v in frames:
            f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())


def read_y4m(path: str, max_frames: int | None = None):
    """Read a YUV4MPEG2 file -> (frames, width, height, fps)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            header += f.read(1)
        m_w = re.search(rb"W(\d+)", header)
        m_h = re.search(rb"H(\d+)", header)
        m_f = re.search(rb"F(\d+):(\d+)", header)
        if not (m_w and m_h):
            raise ValueError("bad y4m header")
        width, height = int(m_w.group(1)), int(m_h.group(1))
        fps = (int(m_f.group(1)), int(m_f.group(2))) if m_f else (25, 1)
        if b"C" in header and not re.search(rb"C420(\b|jpeg|mpeg2|paldv)", header):
            raise NotImplementedError("only 4:2:0 y4m supported")
        ysz, csz = width * height, (width // 2) * (height // 2)
        frames = []
        while max_frames is None or len(frames) < max_frames:
            tag = f.readline()
            if not tag.startswith(b"FRAME"):
                break
            buf = f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                break
            arr = np.frombuffer(buf, dtype=np.uint8)
            frames.append(
                (
                    arr[:ysz].reshape(height, width),
                    arr[ysz : ysz + csz].reshape(height // 2, width // 2),
                    arr[ysz + csz :].reshape(height // 2, width // 2),
                )
            )
    return frames, width, height, fps


def read_yuv420_10(path: str, width: int, height: int,
                   max_frames: int | None = None):
    """Read raw planar yuv420p10le frames -> list of (y, u, v) uint16."""
    ysz, csz = width * height, (width // 2) * (height // 2)
    frame_sz = 2 * (ysz + 2 * csz)
    frames = []
    with open(path, "rb") as f:
        while max_frames is None or len(frames) < max_frames:
            buf = f.read(frame_sz)
            if len(buf) < frame_sz:
                break
            arr = np.frombuffer(buf, dtype="<u2")
            frames.append((arr[:ysz].reshape(height, width),
                           arr[ysz : ysz + csz].reshape(height // 2,
                                                        width // 2),
                           arr[ysz + csz :].reshape(height // 2,
                                                    width // 2)))
    return frames


def write_yuv420_10(path: str, frames) -> None:
    with open(path, "wb") as f:
        for y, u, v in frames:
            for p in (y, u, v):
                f.write(np.ascontiguousarray(p, dtype="<u2").tobytes())


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def synthetic_frames(width: int, height: int, n: int, seed: int = 0):
    """Deterministic moving-gradient + texture test content."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (height + 64, width + 64), dtype=np.uint8)
    # smooth it for realistic spectra
    base = (
        base.astype(np.int32)
        + np.roll(base, 1, 0)
        + np.roll(base, 1, 1)
        + np.roll(base, (1, 1), (0, 1))
    ) // 4
    xs = np.arange(width)[None, :]
    ys = np.arange(height)[:, None]
    frames = []
    for t in range(n):
        grad = ((xs * 2 + ys + t * 3) % 256).astype(np.int32)
        tt = t % 64  # the texture pad is 64 px: wrap long sequences
        tex = base[tt : tt + height, tt : tt + width]
        y = ((grad + tex) // 2).astype(np.uint8)
        u = ((128 + (xs // 2 - t) % 64).astype(np.uint8))[0:1, : width // 2].repeat(height // 2, 0)
        u = np.ascontiguousarray(u)
        v = np.full((height // 2, width // 2), 100 + (t * 5) % 56, np.uint8)
        frames.append((y, u, v))
    return frames


def synthetic_frames_10(width: int, height: int, n: int, seed: int = 0):
    """10-bit test content: the 8-bit synthetic frames scaled to the
    10-bit range plus deterministic low bits (so the extra precision is
    actually exercised, not just zero-padded)."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for (y, u, v) in synthetic_frames(width, height, n, seed=seed):
        def up(p):
            lo = rng.integers(0, 4, p.shape, dtype=np.uint16)
            return (p.astype(np.uint16) << 2) | lo
        out.append((up(y), up(u), up(v)))
    return out
