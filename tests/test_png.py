"""The stdlib PNG codec (utils/image.py) against Pillow."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from feature_detector_fast_tpu.utils import image as imutil

MEDIA = os.path.join(os.path.dirname(__file__), os.pardir, "media")


@pytest.mark.parametrize("name", ["Screenshot315_torch.png",
                                  "Screenshot315_torch_grey.png",
                                  "golden_1080p.png"])
def test_media_decode_matches_pil(name):
    path = os.path.join(MEDIA, name)
    pil = Image.open(path)
    raw = imutil.read_png(path)
    want = np.asarray(pil)
    np.testing.assert_array_equal(raw.reshape(want.shape), want)
    np.testing.assert_array_equal(imutil.load_rgb8(path),
                                  np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_round_trip_through_pil(tmp_path, rng, channels):
    """What write_png encodes Pillow decodes, and what Pillow encodes
    (with its own filter choices) read_png decodes."""
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    a = rng.integers(0, 256, shape, np.uint8)
    ours = str(tmp_path / "ours.png")
    imutil.write_png(a, ours)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), a)
    theirs = str(tmp_path / "theirs.png")
    Image.fromarray(a).save(theirs, optimize=True)
    np.testing.assert_array_equal(imutil.read_png(theirs).reshape(shape), a)


def _filter_rows(a: np.ndarray, ftype: int) -> bytes:
    """Encode every row of an (H, W, C) uint8 image with one PNG filter
    (the specification's forward filters, written plainly)."""
    h, w, c = a.shape
    img = a.astype(np.int64).reshape(h, w * c)
    out = bytearray()
    for y in range(h):
        prev = img[y - 1] if y else np.zeros(w * c, np.int64)
        line = img[y]
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(line)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out.extend(((line - pred) & 0xFF).astype(np.uint8).tobytes())
    return bytes(out)


@pytest.mark.parametrize("ftype", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
def test_each_row_filter_decodes(tmp_path, rng, ftype):
    a = rng.integers(0, 256, (19, 23, 3), np.uint8)
    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 23, 19, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(_filter_rows(a, ftype)))
           + chunk(b"IEND", b""))
    path = tmp_path / "f.png"
    path.write_bytes(png)
    np.testing.assert_array_equal(imutil.read_png(str(path)), a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)


def test_unsupported_png_is_refused(tmp_path):
    path = str(tmp_path / "deep.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)  # 16-bit gray
    with pytest.raises(ValueError):
        imutil.read_png(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        imutil.read_png(str(bad))
