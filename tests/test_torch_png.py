"""The port's PNG reader and writer (datasets/png.py) against cv2.

- `imread` against `cv2.imread` byte for byte, under IMREAD_COLOR and
  IMREAD_UNCHANGED, on PNGs that cv2 writes (8-bit grey, BGR, BGRA; 16-bit
  grey and BGR) and on PNGs that a test-local encoder writes with each of
  the filters None, Sub, Up, Average and Paeth (and all five mixed) at odd
  widths, since cv2 writes only Sub;
- unsupported forms (palette, grey + alpha, sub-8-bit, interlaced) raise;
- `imwrite` then `cv2.imread` round-trips exactly, with cv2's Sub rows and
  with each of the other filters (the same filtered bytes as the test-local
  encoder).
"""

import struct
import sys
import zlib
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import cv2
import numpy as np
import pytest

from unified_cvo_tpu_torch.datasets import png

SHAPES = {"grey8": ((23, 37), np.uint8), "bgr8": ((19, 33, 3), np.uint8),
          "bgra8": ((17, 29, 4), np.uint8), "grey16": ((21, 35), np.uint16),
          "bgr16": ((15, 27, 3), np.uint16)}


def _image(kind, seed):
    shape, dtype = SHAPES[kind]
    rng = np.random.default_rng(seed)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=np.int64)
    # smooth stretches make the predictors (and Paeth's ties) matter
    img[: shape[0] // 2] = np.cumsum(img[: shape[0] // 2] % 7, axis=1) * 3
    return (img % (np.iinfo(dtype).max + 1)).astype(dtype)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(path, img, filters, interlace=0, depth=None, ctype=None, extra=b""):
    """A plain PNG encoder: row y is filtered with filters[y % len]."""
    img = np.asarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch >= 3:
        img = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
    H, W = img.shape[:2]
    depth = depth or 8 * img.dtype.itemsize
    ctype = {1: 0, 3: 2, 4: 6}[ch] if ctype is None else ctype
    data = img.astype(">u2") if img.dtype == np.uint16 else img
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(H, -1).astype(np.int64)
    bpp = max(1, ch * img.dtype.itemsize)
    out = bytearray()
    for y in range(H):
        f = filters[y % len(filters)]
        out.append(f)
        for i in range(rows.shape[1]):
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y else 0
            c = rows[y - 1, i - bpp] if y and i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            out.append((rows[y, i] - pred) & 0xFF)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                              interlace))
                 + extra + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def _same(ours, ref):
    assert ours is not None and ref is not None
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_imread_equals_cv2_on_cv2s_files(kind, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, _image(kind, 0))
    _same(png.imread(path), cv2.imread(path))
    _same(png.imread(path, unchanged=True), cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 0, 3, 1, 2]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_imread_undoes_every_filter(kind, filters, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    _encode(path, _image(kind, 1), filters)
    _same(png.imread(path), cv2.imread(path))
    _same(png.imread(path, unchanged=True), cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("case", ["palette", "grey_alpha", "four_bit", "interlaced",
                                  "trns", "bad_crc"])
def test_unsupported_forms_raise(case, tmp_path):
    path = str(tmp_path / f"{case}.png")
    grey = _image("grey8", 2)
    if case == "palette":
        _encode(path, grey, [0], ctype=3)
    elif case == "grey_alpha":
        _encode(path, grey, [0], ctype=4)
    elif case == "four_bit":
        _encode(path, grey[:, :18], [0], depth=4)
    elif case == "interlaced":
        _encode(path, grey, [0], interlace=1)
    elif case == "trns":
        body = b"\x00\x07"
        _encode(path, grey, [0], extra=struct.pack(">I", 2) + b"tRNS" + body
                + struct.pack(">I", zlib.crc32(b"tRNS" + body)))
    else:
        png.imwrite(path, grey)
        data = bytearray(open(path, "rb").read())
        data[-20] ^= 0xFF                               # inside the IDAT chunk
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match=path.rsplit("/", 1)[-1]):
        png.imread(path)


def test_missing_file_gives_none(tmp_path):
    assert png.imread(str(tmp_path / "absent.png")) is None
    assert cv2.imread(str(tmp_path / "absent.png")) is None


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_imwrite_round_trips_through_cv2(kind, tmp_path):
    img = _image(kind, 3)
    path = str(tmp_path / f"{kind}.png")
    assert png.imwrite(path, img)
    _same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    _same(png.imread(path, unchanged=True), img)
    _same(png.imread(path), cv2.imread(path))


def _filtered_bytes(path):
    """The decompressed image data: every row's filter type and bytes."""
    data, pos, idat = open(path, "rb").read(), 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if kind == b"IDAT" else b""
        pos += 12 + n
    return zlib.decompress(idat)


@pytest.mark.parametrize("filters", [[0], [2], [3], [4], [4, 0, 3, 1, 2]],
                         ids=["none", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_imwrite_filters_round_trip_through_cv2(kind, filters, tmp_path):
    img = _image(kind, 4)
    path = str(tmp_path / f"{kind}.png")
    assert png.imwrite(path, img, filters)
    ref = str(tmp_path / "ref.png")
    _encode(ref, img, filters)
    assert _filtered_bytes(path) == _filtered_bytes(ref)      # the same filter bytes
    _same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    _same(png.imread(path, unchanged=True), img)
    _same(png.imread(path), cv2.imread(path))


def test_imwrite_rejects_unknown_filters(tmp_path):
    with pytest.raises(ValueError, match="filters"):
        png.imwrite(str(tmp_path / "x.png"), _image("grey8", 0), [5])


def _decode_ms(path, unchanged, reps=3):
    import time

    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        png.imread(path, unchanged)
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


if __name__ == "__main__":
    # host decode times at 640 x 480 (cv2's Sub rows, and all five filters)
    import tempfile

    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (480, 640, 3), np.uint8)
    d16 = rng.integers(0, 65536, (480, 640), np.uint16)
    with tempfile.TemporaryDirectory() as d:
        for name, img in (("bgr8", bgr), ("depth16", d16)):
            p = f"{d}/{name}.png"
            png.imwrite(p, img)
            print(f"{name} Sub rows: {_decode_ms(p, name == 'depth16'):.2f} ms")
            _encode(p, img, [0, 1, 2, 3, 4])
            print(f"{name} all filters: {_decode_ms(p, name == 'depth16', 1):.2f} ms")
