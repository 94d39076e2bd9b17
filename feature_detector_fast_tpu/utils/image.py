"""Image I/O, color conversion, and keypoint overlay drawing.

Parity targets in the reference:
  * `DynamicImage::to_luma8` — the image crate's sRGB-coefficient
    luma conversion used by the CLI and tests (main.rs:58,
    tests/compare.rs:33).  For already-gray inputs (R==G==B) it is an exact
    identity, which is what the committed test image exercises.
  * `Rgb8ToLuma16View` — channel-sum luma16 and the /3 gray variant
    (util.rs:6-41); intentionally different from weighted luma, kept for
    API parity.
  * `draw_plus_sized` overlay drawing (util.rs:62-81) including its exact
    boundary behavior (skips px<=0 / py<=0 and px>=w / py>=h).

PNG files are read and written by a small codec on stdlib `zlib` and
numpy: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, all five
row filters.  That covers the committed media and everything the CLI
writes; anything else raises ValueError.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, Sequence, Tuple

import numpy as np

# Color constants (reference: util.rs:44-50).
WHITE = (255, 255, 255)
RED = (255, 0, 0)
GREEN = (0, 255, 0)
BLUE = (0, 0, 255)


def rgb_to_luma8(rgb: np.ndarray) -> np.ndarray:
    """sRGB-coefficient luma, mirroring the image crate's `to_luma8`.

    luma = (2126*R + 7152*G + 722*B) / 10000 with integer truncation
    (image-rs 0.24 `rgb_to_luma`).  Exact identity for gray inputs.
    """
    rgb = np.asarray(rgb, dtype=np.uint32)
    l = (2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2]) // 10000
    return l.astype(np.uint8)


def rgb_to_luma16_sum(rgb: np.ndarray) -> np.ndarray:
    """Channel-sum luma16 view (reference: util.rs:37-40)."""
    rgb = np.asarray(rgb, dtype=np.uint16)
    return rgb[..., 0] + rgb[..., 1] + rgb[..., 2]


def rgb_to_grey_third(rgb: np.ndarray) -> np.ndarray:
    """`Rgb8ToLuma16View::to_grey` (util.rs:15-25): pixel[0] of the luma16
    VIEW is the channel sum (util.rs:37-40), so gray = (R+G+B) / 3 with
    integer truncation."""
    return (rgb_to_luma16_sum(rgb) // 3).astype(np.uint8)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels (8-bit depth only).
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _unfilter(raw: bytes, h: int, w: int, channels: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth).

    Pixel (y, x) depends on its left, upper and upper-left neighbours, so
    it is reconstructed one anti-diagonal (x + y constant) at a time, all
    of a diagonal's pixels at once: H + W - 1 vector steps."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (w * channels + 1):
        raise ValueError("PNG data has the wrong size for its header")
    rows = rows.reshape(h, w * channels + 1)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    line = rows[:, 1:].reshape(h, w, channels).astype(np.int32)
    # One zero row above and one zero column to the left stand in for the
    # neighbours outside the image.
    out = np.zeros((h + 1, w + 1, channels), np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]       # left
        b = out[y, x + 1]       # up
        c = out[y, x]           # upper left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (line[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG to an (H, W, C) uint8 array, C in {1, 2, 3, 4}
    (gray, gray+alpha, RGB, RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w,
                     _PNG_CHANNELS[color])


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(array: np.ndarray, path: str) -> None:
    """Encode an (H, W) gray or (H, W, C) uint8 array as PNG (filter
    None on every row)."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, channels = a.shape
    color = {v: k for k, v in _PNG_CHANNELS.items()}.get(channels)
    if color is None:
        raise ValueError(f"cannot write {channels} channels as PNG")
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), a.reshape(h, w * channels)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def load_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: gray is replicated and alpha dropped, as the
    image crate's `to_rgb8` does."""
    px = read_png(path)
    channels = px.shape[-1]
    if channels <= 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def load_luma8(path: str) -> np.ndarray:
    """Load an image file and convert to uint8 luma exactly like the
    reference CLI does (open -> rgb8 -> to_luma8; main.rs:53-58)."""
    return rgb_to_luma8(load_rgb8(path))


def save_image(array: np.ndarray, path: str) -> None:
    write_png(array, path)


def draw_plus_sized(
    image: np.ndarray,
    xy: Tuple[int, int],
    color: Sequence[int],
    size: int = 3,
) -> None:
    """Draw a plus marker in-place on an (H, W, 3) uint8 image.

    Bit-faithful to util.rs:62-81: arms of length ``size`` in the four
    cardinal directions, skipping positions with px<=0, py<=0, px>=w, py>=h.
    """
    h, w = image.shape[:2]
    x, y = int(xy[0]), int(xy[1])
    for dxs, dys in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        for l in range(int(size)):
            px = x + dxs * l
            py = y + dys * l
            if px <= 0 or px >= w or py <= 0 or py >= h:
                continue
            image[py, px] = color


def make_circle_image() -> np.ndarray:
    """Debug image of the 16 circle points: 32x32 RGB with blue dots
    around center (16, 16) (reference: opencv_compat.rs:69-76)."""
    from ..geometry import CIRCLE

    img = np.zeros((32, 32, 3), np.uint8)
    for dx, dy in CIRCLE:
        img[16 + dy, 16 + dx] = BLUE
    return img


def draw_keypoints(
    luma: np.ndarray, keypoints: Iterable[Tuple[int, int]], color=RED, size: int = 1
) -> np.ndarray:
    """Gray image + keypoints -> RGB overlay (CLI behavior, main.rs:74-78)."""
    rgb = np.repeat(np.asarray(luma, np.uint8)[..., None], 3, axis=-1).copy()
    for kp in keypoints:
        draw_plus_sized(rgb, (int(kp[0]), int(kp[1])), color, size)
    return rgb
