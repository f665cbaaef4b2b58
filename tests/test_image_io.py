"""PNG/QOI/PPM encoders (reference driver.c:839-874) + native codec."""

import os

import numpy as np
import pytest

from raytracing_jax.io import image_io


@pytest.fixture
def img(rng):
    # mix of flat runs and noise to exercise all QOI ops
    a = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    a[:10, :20] = [10, 200, 30]
    a[20:, 30:] = a[20:, 30:] // 2 * 2
    return a


def test_qoi_roundtrip_python(img):
    data = image_io._qoi_encode_py(img)
    out = image_io._qoi_decode_py(data)
    assert (out == img).all()


def test_qoi_roundtrip_native(img):
    from raytracing_jax.native import qoi_native

    codec = qoi_native()
    if codec is None:
        pytest.skip("no C compiler available")
    data = codec.encode(img)
    assert data[:4] == b"qoif"
    out = codec.decode(data)
    assert (out == img).all()
    # cross-check: native bytes decode with the python decoder too
    out2 = image_io._qoi_decode_py(data)
    assert (out2 == img).all()
    # and python bytes decode natively
    out3 = codec.decode(image_io._qoi_encode_py(img))
    assert (out3 == img).all()


def test_ppm_roundtrip(tmp_path, img):
    p = str(tmp_path / "x.ppm")
    image_io.write_ppm(p, img)
    with open(p, "rb") as f:
        assert f.readline() == b"P6\n"
        w, h = map(int, f.readline().split())
        assert (w, h) == (47, 33)
        assert f.readline() == b"255\n"
        raw = np.frombuffer(f.read(), np.uint8).reshape(33, 47, 3)
    assert (raw == img).all()


def test_png_roundtrip(tmp_path, img):
    p = str(tmp_path / "x.png")
    image_io.write_png(p, img)
    back = image_io.load_image_rgb_u8(p)
    assert (back == img).all()


def test_dispatch_unknown_defaults_to_png(tmp_path, img):
    warnings = []
    p = str(tmp_path / "x.bmpish")
    image_io.write_image(p, img, warn=warnings.append)
    assert warnings and "defaulting to png" in warnings[0]
    assert os.path.exists(p)


# --- PNG through zlib: filters, color types, formats --------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_bytes(raw, w, h, ctype, depth=8, filt=0, plte=None):
    """A PNG written independently of the codec under test: each scanline
    filtered with `filt` (0-4, or "mixed" to cycle through all five)."""
    import struct
    import zlib

    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1).astype(int)
    out = bytearray()
    prior = np.zeros(rows.shape[1], int)
    for y in range(h):
        f = y % 5 if filt == "mixed" else filt
        line = rows[y]
        enc = []
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            enc.append((x - pred) & 255)
        out += bytes([f] + enc)
        prior = line

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if plte is not None:
        png += chunk(b"PLTE", plte.tobytes())
    return png + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(
        b"IEND", b"")


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_png_decodes_filtered_scanlines(filt, img):
    h, w, _ = img.shape
    data = _png_bytes(img.tobytes(), w, h, 2, filt=filt)
    np.testing.assert_array_equal(image_io.decode_image_rgb_u8(data), img)


@pytest.mark.parametrize("kind", ["grey", "grey_alpha", "rgba", "palette",
                                  "rgb16"])
def test_png_color_types_expand_to_rgb(kind, img):
    h, w, _ = img.shape
    grey = img[..., 1]
    if kind == "grey":
        data, want = _png_bytes(grey.tobytes(), w, h, 0, filt=4), \
            np.repeat(grey[..., None], 3, 2)
    elif kind == "grey_alpha":
        ga = np.stack([grey, 255 - grey], -1)
        data, want = _png_bytes(ga.tobytes(), w, h, 4, filt=1), \
            np.repeat(grey[..., None], 3, 2)
    elif kind == "rgba":
        rgba = np.concatenate([img, grey[..., None]], -1)
        data, want = _png_bytes(rgba.tobytes(), w, h, 6, filt=3), img
    elif kind == "palette":
        plte = np.unique(img.reshape(-1, 3), axis=0)[:256]
        idx = np.arange(h * w).reshape(h, w) % len(plte)
        data = _png_bytes(idx.astype(np.uint8).tobytes(), w, h, 3,
                          filt="mixed", plte=plte)
        want = plte[idx]
    else:  # 16 bits per channel, big-endian: the high byte survives
        wide = (img.astype(np.uint16) * 256 + 3).astype(">u2")
        data, want = _png_bytes(wide.tobytes(), w, h, 2, depth=16,
                                filt="mixed"), img
    np.testing.assert_array_equal(image_io.decode_image_rgb_u8(data), want)


def test_png_encoder_writes_a_valid_stream(img):
    import zlib

    data = image_io.png_encode(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    # every chunk's CRC checks out
    pos = 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        body = data[pos + 4:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert zlib.crc32(body) & 0xFFFFFFFF == crc
        pos += 12 + n
    np.testing.assert_array_equal(image_io.png_decode(data), img)


def test_decode_dispatches_qoi_and_ppm(tmp_path, img):
    np.testing.assert_array_equal(
        image_io.decode_image_rgb_u8(image_io.qoi_encode(img)), img)
    p = str(tmp_path / "x.ppm")
    image_io.write_ppm(p, img)
    np.testing.assert_array_equal(image_io.load_image_rgb_u8(p), img)


def test_jpeg_without_pillow_names_the_format(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="JPEG.*Pillow"):
        image_io.decode_image_rgb_u8(b"\xff\xd8\xff\xe0" + b"\0" * 16)


def test_unsupported_png_layout_raises():
    import struct
    import zlib

    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)  # interlaced
    body = b"IHDR" + ihdr
    data = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(ihdr)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))
    with pytest.raises(ValueError, match="interlace"):
        image_io.png_decode(data)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_sub_byte_palette_and_grey(depth, rng):
    h, w = 7, 13
    idx = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
    bits = ((idx[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    packed = np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)
    plte = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
    pal = _png_bytes(packed.tobytes(), w, h, 3, depth=depth, filt="mixed",
                     plte=plte)
    np.testing.assert_array_equal(image_io.decode_image_rgb_u8(pal),
                                  plte[idx])
    grey = _png_bytes(packed.tobytes(), w, h, 0, depth=depth, filt=4)
    scale = 255 // ((1 << depth) - 1)
    np.testing.assert_array_equal(image_io.decode_image_rgb_u8(grey),
                                  np.repeat((idx * scale)[..., None], 3, 2))
