"""An 8-bit PNG reader and writer on the standard library's zlib, for the
PNG codec (compression/codecs.py): gray, RGB and RGBA images, no
interlacing.

The writer filters each row adaptively: of the five PNG filters it takes
the one whose filtered bytes, read as signed, have the least sum of
absolute values (libpng's heuristic; the lowest filter type on a tie), and
deflates at zlib level 6. The reader undoes all five filters, whichever
encoder chose them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels
ZLIB_LEVEL = 6


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor, elementwise on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img: np.ndarray, bpp: int) -> bytes:
    """The filtered scanlines, each prefixed by its filter type."""
    h = img.shape[0]
    x = img.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]  # the byte one pixel to the left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # the byte above
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]  # above and to the left
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1),
                      x - _paeth(a, b, c)]).astype(np.uint8)  # [5, H, W*bpp]
    signed = cands.astype(np.int8).astype(np.int32)
    cost = np.abs(signed).sum(-1)  # [5, H]
    best = np.argmin(cost, axis=0)  # the first of equal costs
    rows = cands[best, np.arange(h)]
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = rows
    return out.tobytes()


def write_png(path: str, img: np.ndarray) -> None:
    """Writes uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of uint8 [H, W], [H, W, 3] or [H, W, 4], as bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: dtype {img.dtype}, expected uint8")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPES:
        raise ValueError(f"encode_png: {ch} channels (1, 3 or 4)")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[ch], 0, 0, 0)
    data = zlib.compress(_filter_rows(np.ascontiguousarray(img), ch),
                         ZLIB_LEVEL)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
            + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undoes the five filters row by row -> uint8 [h, stride]."""
    src = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, f = int(src[y, 0]), src[y, 1:]
        if ftype == 0:
            row = f.copy()
        elif ftype == 1:  # Sub: a running sum along each channel
            row = np.empty(stride, np.uint8)
            for c in range(bpp):
                row[c::bpp] = np.cumsum(f[c::bpp], dtype=np.uint64) & 0xFF
        elif ftype == 2:  # Up
            row = f + prev
        elif ftype in (3, 4):  # Average and Paeth: left to right
            fb, up, r = f.tobytes(), prev.tobytes(), bytearray(stride)
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    r[i] = (fb[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                r[i] = (fb[i] + pred) & 0xFF
            row = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"read_png: filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Reads an 8-bit, non-interlaced gray, gray-alpha, RGB or RGBA PNG ->
    uint8 [H, W] for gray, else [H, W, C]."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        n, = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (8-bit, not interlaced, "
                         f"gray/RGB/RGBA)")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)
