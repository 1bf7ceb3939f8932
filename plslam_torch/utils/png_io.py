"""PNG files in numpy and Python's ``zlib``: a writer for the datasets the
port makes of its rendered frames, and a plain decoder of what the writer
writes, the reference the native decoder (``plslam_torch/native``) is held
against.

The writer filters row ``y`` with PNG filter type ``y % 5`` (None, Sub, Up,
Average, Paeth), so every unfilter path of a decoder runs on its files, and
splits the zlib stream into IDAT chunks of ``idat_bytes``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor of int arrays a (left), b (up), c (upper left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _rows(img: np.ndarray) -> tuple[np.ndarray, int]:
    """(h, row bytes) uint8 big-endian rows of an image, and bytes per pixel."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype == np.uint16:
        return img.astype(">u2").view(np.uint8).reshape(h, w * ch * 2), 2 * ch
    return img.reshape(h, w * ch).astype(np.uint8), ch


def write_png(path, img: np.ndarray, level: int = 6, idat_bytes: int = 1 << 15) -> None:
    """Write ``img`` (h, w) or (h, w, channels), uint8 or uint16, as a PNG."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples are uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    raw, bpp = _rows(img)
    x = raw.astype(np.int16)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    kind = np.arange(h) % 5
    filtered = x.copy()  # type 0 rows stay as they are
    for f in range(1, 5):
        r = kind == f
        xr, ur = x[r], up[r]
        left = np.hstack([np.zeros_like(xr[:, :bpp]), xr[:, :-bpp]])
        if f == 1:
            pred = left
        elif f == 2:
            pred = ur
        elif f == 3:
            pred = (left + ur) >> 1
        else:
            pred = _paeth(left, ur, np.hstack([np.zeros_like(ur[:, :bpp]), ur[:, :-bpp]]))
        filtered[r] = xr - pred
    body = np.hstack([kind[:, None], filtered & 0xFF]).astype(np.uint8).tobytes()
    z = zlib.compress(body, level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.itemsize, _COLOR[ch], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIG + _chunk(b"IHDR", ihdr))
        for i in range(0, len(z), idat_bytes):
            fh.write(_chunk(b"IDAT", z[i:i + idat_bytes]))
        fh.write(_chunk(b"IEND", b""))


def _parse(path):
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: CRC of {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, bd, ct, _, _, interlace = hdr
    if bd not in (8, 16) or ct not in (0, 2, 4, 6) or interlace:
        raise ValueError(f"{path}: the plain decoder reads non-interlaced 8/16-bit "
                         "gray, gray+alpha, RGB and RGBA")
    return w, h, bd, {0: 1, 4: 2, 2: 3, 6: 4}[ct], zlib.decompress(b"".join(idat))


def decode_plain(paths) -> list[np.ndarray]:
    """The plain decode of PNG files of one size and type (non-interlaced,
    8- or 16-bit gray, gray+alpha, RGB or RGBA): (h, w, channels) uint8 or
    uint16 each. The rows are unfiltered for all files at once (Average and
    Paeth go pixel by pixel along a row)."""
    parsed = [_parse(p) for p in paths]
    w, h, bd, ch = parsed[0][:4]
    if any(p[:4] != (w, h, bd, ch) for p in parsed):
        raise ValueError("decode_plain takes files of one size and type")
    bpp = ch * bd // 8
    rb = w * bpp
    z = np.stack([np.frombuffer(p[4], np.uint8, count=h * (rb + 1)) for p in parsed])
    z = z.reshape(len(paths), h, rb + 1)
    out = np.zeros((len(paths), h, rb), np.uint8)
    prev = np.zeros((len(paths), rb), np.int32)
    for y in range(h):
        ft = z[:, y, 0]
        cur = z[:, y, 1:].astype(np.int32)
        row = cur.copy()
        up = (cur + prev) & 0xFF
        row = np.where((ft == 2)[:, None], up, row)
        sub = (ft == 1)
        if sub.any():  # Sub: a running sum along each byte lane of a pixel
            lanes = cur[sub].reshape(-1, w, bpp).cumsum(1) & 0xFF
            row[sub] = lanes.reshape(-1, rb)
        slow = (ft == 3) | (ft == 4)
        if slow.any():
            s, c, p = row[slow], cur[slow], prev[slow]
            avg, pae = (ft[slow] == 3)[:, None], (ft[slow] == 4)[:, None]
            for x in range(0, rb, bpp):
                sl = slice(x, x + bpp)
                a = s[:, x - bpp:x] if x else np.zeros_like(c[:, sl])
                ul = p[:, x - bpp:x] if x else np.zeros_like(c[:, sl])
                b = p[:, sl]
                s[:, sl] = np.where(avg, (c[:, sl] + ((a + b) >> 1)) & 0xFF,
                                    np.where(pae, (c[:, sl] + _paeth(a, b, ul)) & 0xFF,
                                             s[:, sl]))
            row[slow] = s
        if (ft > 4).any():
            raise ValueError(f"filter type {int(ft.max())} in row {y}")
        out[:, y] = row
        prev = row
    if bd == 16:
        b = out.reshape(len(paths), h, w * ch, 2).astype(np.uint16)
        return list(((b[..., 0] << 8) | b[..., 1]).reshape(len(paths), h, w, ch))
    return list(out.reshape(len(paths), h, w, ch))
