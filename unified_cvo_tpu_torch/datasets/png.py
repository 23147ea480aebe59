"""PNG reading and writing in numpy and stdlib zlib, in place of
`cv2.imread` and `cv2.imwrite`, which the JAX package calls.

So that the port runs on a host without OpenCV, its image readers
(`datasets/tum.py`, `datasets/kitti.py`, `datasets/tartanair.py`) and the
fixture writers of `utils/synth.py` go through this module.

`imread(path, unchanged=False)` follows cv2's two flags:
- `IMREAD_COLOR` (the default): uint8 [H, W, 3] in BGR order. Grey is
  replicated into three channels, alpha is dropped, and 16-bit samples keep
  their high byte, as cv2 (libpng's strip_16) gives them.
- `IMREAD_UNCHANGED` (`unchanged=True`): the samples as stored, uint8 or
  uint16, [H, W] for grey, BGR(A) order for colour.
It reads bit depths 8 and 16 of grey (colour type 0), RGB (2) and RGBA (6),
non-interlaced, with any of the five row filters. Palette, grey + alpha,
interlaced, sub-8-bit and transparency-keyed files raise ValueError naming
the file. A missing file gives None, as cv2.imread does.

Unfiltering: rows filtered with None, Sub or Up (all that cv2 writes: Sub)
are undone row by row, Sub as a uint8 cumulative sum along the row. A file
with Average or Paeth rows is undone over the anti-diagonals y + x = d of
the pixel grid (H + W - 1 numpy steps): every pixel of a diagonal depends
only on the two diagonals before it, whatever its row's filter.

`imwrite(path, img, filters=(1,))` writes uint8 or uint16 [H, W], [H, W, 3]
(BGR) or [H, W, 4] (BGRA), zlib level 6, row y filtered with
filters[y % len]: by default Sub on every row (what cv2 writes).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples a pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r} chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(t, a, b, c):
    """Each filter's predictor from left a, up b and up-left c (int32),
    chosen by filter type t."""
    return np.where(t == 1, a, np.where(t == 2, b, np.where(
        t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))


def _unfilter_rows(ftype: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered with None (0), Sub (1) or Up (2): row by row."""
    H, stride = rows.shape
    out = np.empty_like(rows)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        r = rows[y]
        if ftype[y] == 1:
            r = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype[y] == 2:
            r = r + prev
        out[y] = r
        prev = out[y]
    return out


def _unfilter_diagonals(ftype: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters: one numpy step per anti-diagonal of the
    pixel grid. Left (y, x-1) and up (y-1, x) lie on the diagonal before,
    up-left on the one before that."""
    H, stride = rows.shape
    W = stride // bpp
    filt = rows.reshape(H, W, bpp).astype(np.int32)
    out = np.zeros((H + 1, W + 1, bpp), np.int32)     # a zero row and column first
    ft = ftype.astype(np.int32)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - y
        a = out[y + 1, x]                             # left
        b = out[y, x + 1]                             # up
        c = out[y, x]                                 # up-left
        out[y + 1, x + 1] = (filt[y, x] + _predict(ft[y][:, None], a, b, c)) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(H, stride)


def imread(path: str, unchanged: bool = False) -> Optional[np.ndarray]:
    """cv2.imread(path) (or cv2.imread(path, cv2.IMREAD_UNCHANGED) with
    `unchanged=True`) of a PNG file; None where the file does not exist."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"PLTE", b"tRNS"):
            raise ValueError(f"{path}: {kind.decode()} chunks are not supported")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not supported "
                         "(grey, RGB and RGBA only)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 and 16 only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"expected {H * (1 + W * bpp)}")
    raw = raw.reshape(H, 1 + W * bpp)
    ftype, rows = raw[:, 0], raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown filter type {int(ftype.max())}")
    if ftype.max(initial=0) <= 2:
        rows = _unfilter_rows(ftype, rows, bpp)
    else:
        rows = _unfilter_diagonals(ftype, rows, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(H, W, ch)
    else:
        img = rows.reshape(H, W, ch)
    if unchanged:
        if ch == 1:
            return np.ascontiguousarray(img[..., 0])
        order = [2, 1, 0] + ([3] if ch == 4 else [])
        return np.ascontiguousarray(img[..., order])
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    if ch == 1:
        return np.ascontiguousarray(np.repeat(img, 3, axis=2))
    return np.ascontiguousarray(img[..., [2, 1, 0]])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def imwrite(path: str, img: np.ndarray, filters: Sequence[int] = (1,)) -> bool:
    """cv2.imwrite(path, img) for a PNG: uint8 or uint16 [H, W], BGR
    [H, W, 3] or BGRA [H, W, 4]. Row y is filtered with filters[y % len]
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); the default, Sub on every
    row, is what cv2 writes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: imwrite takes uint8 or uint16, got {img.dtype}")
    if not filters or any(f not in range(5) for f in filters):
        raise ValueError(f"{path}: row filters are 0-4, got {list(filters)}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"{path}: imwrite takes 1, 3 or 4 channels, got {ch}")
    if ch >= 3:
        img = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
    depth = 8 * img.dtype.itemsize
    bpp = ch * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    x = rows.view(np.uint8).reshape(H, W * bpp).astype(np.int32)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    ft = np.asarray(filters, np.uint8)[np.arange(H) % len(filters)]
    filt = (x - _predict(ft[:, None], a, b, c)) & 0xFF
    raw = np.concatenate([ft[:, None], filt.astype(np.uint8)], axis=1)
    png = (_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return True
