"""8-bit PNG reader and writer on ``zlib`` and numpy, in OpenCV's channel
order, so that the port reads and writes scene images without OpenCV.

``read_png`` gives what ``cv2.imread(path)`` gives: [H, W, 3] uint8 in
BGR order, a gray image's channel repeated three times, an alpha channel
dropped. It reads gray, gray + alpha, RGB and RGBA images of bit depth 8,
not interlaced, with any of the five row filters. ``write_png`` takes
what ``cv2.imwrite`` takes (BGR, BGRA or gray uint8) and writes every row
unfiltered.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n


def _unfilter_average(line: bytes, up: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 255
    return bytes(cur)


def _unfilter_paeth(line: bytes, up: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        if i >= bpp:
            a, c = cur[i - bpp], up[i - bpp]
        else:
            a = c = 0
        b = up[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return bytes(cur)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Rows [H, 1 + stride] (filter byte first) -> pixels [H, stride]."""
    H, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum over the pixels, per sample
            cur = (line.reshape(-1, bpp).astype(np.int64).cumsum(axis=0) & 255) \
                .astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(line.tobytes(), prior.tobytes(), bpp),
                                np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(), prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 BGR, as ``cv2.imread(path)`` reads it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit gray / RGB (with or without alpha), "
                         f"not interlaced, is read (depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw[:H * (1 + W * bpp)].reshape(H, 1 + W * bpp), bpp).reshape(H, W, bpp)
    rgb = np.repeat(px[..., :1], 3, axis=-1) if bpp <= 2 else px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 ``img`` as ``cv2.imwrite(path, img)`` would: [H, W, 3]
    BGR, [H, W, 4] BGRA, or [H, W] / [H, W, 1] gray."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    channels = img.shape[2]
    if channels == 1:
        color, px = 0, img
    elif channels == 3:
        color, px = 2, img[..., ::-1]
    elif channels == 4:
        color, px = 6, img[..., [2, 1, 0, 3]]
    else:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {channels}")
    H, W = px.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), px.reshape(H, W * channels)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))
