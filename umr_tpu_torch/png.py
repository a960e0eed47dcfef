"""8-bit PNG files with the standard library's zlib: the port's stand-in
for imageio, which the machine with the card lacks.

write_png writes grey [H,W], RGB [H,W,3] and RGBA [H,W,4] uint8 images
(filter 0 on every row). read_png reads 8-bit grey, grey + alpha, RGB
and RGBA files, non-interlaced, with any of the five scanline filters
and the image data split over any number of IDAT chunks, as imageio and
Pillow write them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for bit depth 8
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img):
    """uint8 [H,W], [H,W,3] or [H,W,4] -> the bytes of a PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write 8-bit images: got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"grey, RGB or RGBA images only: shape {img.shape}")
    H, W, C = img.shape
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    rows = np.zeros((H, 1 + W * C), np.uint8)      # filter byte 0 per row
    rows[:, 1:] = img.reshape(H, W * C)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind, line, prev, bpp):
    """One scanline (bytearray, without its filter byte) in place."""
    n = len(line)
    if kind == 0:
        return
    if kind == 1:                                   # Sub: a running sum
        px = np.frombuffer(bytes(line), np.uint8).reshape(-1, bpp)
        line[:] = np.cumsum(px, axis=0, dtype=np.uint8).tobytes()
    elif kind == 2:                                 # Up
        line[:] = (np.frombuffer(bytes(line), np.uint8)
                   + np.frombuffer(bytes(prev), np.uint8)).tobytes()
    elif kind == 3:                                 # Average
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif kind == 4:                                 # Paeth
        for i in range(n):
            if i >= bpp:
                a, c = line[i - bpp], prev[i - bpp]
            else:
                a = c = 0
            line[i] = (line[i] + _paeth(a, prev[i], c)) & 0xFF
    else:
        raise ValueError(f"unknown PNG filter type {kind}")


def decode_png(data):
    """The bytes of an 8-bit PNG file -> uint8 [H,W] (grey) or [H,W,C]
    (C = 2 grey + alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {color}, interlace "
            f"{interlace}: only 8-bit non-interlaced grey, grey + alpha, RGB "
            "and RGBA are read")
    C = _CHANNELS[color]
    stride = W * C
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{H * (stride + 1)}")
    out = bytearray(H * stride)
    prev = bytearray(stride)
    for y in range(H):
        start = y * (stride + 1)
        line = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter(raw[start], line, prev, C)
        out[y * stride:(y + 1) * stride] = line
        prev = line
    img = np.frombuffer(bytes(out), np.uint8).reshape(H, W, C)
    return img[..., 0] if C == 1 else img


def read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_image(path):
    """An image file the port can read without imageio: PNG only."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "this format"
        raise NotImplementedError(
            f"{path}: {kind} is not read by the port (it has an 8-bit PNG "
            "reader only; the machine with the card has no imageio or cv2): "
            "convert the image to PNG")
    return decode_png(data)
