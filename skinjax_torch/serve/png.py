"""A small PNG codec on the standard library's ``zlib`` and numpy.

The serving API decodes uploaded images with it where OpenCV is absent. It
reads 8-bit, non-interlaced RGB and RGBA PNGs, all five scanline filters,
and drops the alpha channel (as ``cv2.IMREAD_COLOR`` does). Other PNG kinds
raise ``UnsupportedPNG``; malformed data raises ``ValueError``.
``encode_png`` writes 8-bit RGB/RGBA PNGs with one scanline filter on
every row (none by default; Paeth, which photographs' encoders often pick,
where asked).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type → bytes per pixel at bit depth 8


class UnsupportedPNG(ValueError):
    """A well-formed PNG of a kind this reader does not decode."""


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"CRC mismatch in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _unfilter_sequential(ftype: int, line: list, prior: list, bpp: int) -> list:
    """Average (3) and Paeth (4): each byte depends on the one decoded left of it."""
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (H, W, 3) RGB."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise UnsupportedPNG(
            f"PNG with bit depth {depth}, colour type {color}, interlace {interlace}"
        )
    if compression != 0 or filt != 0:
        raise ValueError("PNG with an unknown compression or filter method")
    bpp = _CHANNELS[color]
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prior  # uint8 arithmetic wraps mod 256
        elif ftype in (3, 4):
            cur = np.asarray(
                _unfilter_sequential(ftype, line.tolist(), prior.tolist(), bpp), np.uint8
            )
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return np.ascontiguousarray(out.reshape(height, width, bpp)[:, :, :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _paeth_filter(lines: np.ndarray, bpp: int) -> np.ndarray:
    """Filter 4 of every row of (H, stride) raw bytes: each byte minus the
    Paeth predictor of its left, upper and upper-left raw neighbours."""
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, paeth: bool = False) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W, 4) RGBA → PNG bytes, every row
    unfiltered, or Paeth-filtered with ``paeth``."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes uint8 (H, W, 3|4), got {image.dtype} {image.shape}")
    height, width, channels = image.shape
    color = 2 if channels == 3 else 6
    lines = image.reshape(height, width * channels)
    if paeth:
        lines = _paeth_filter(lines, channels)
    rows = np.concatenate([np.full((height, 1), 4 if paeth else 0, np.uint8), lines], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
