"""Image decode/encode.

Covers the reference's codin surface (SURVEY §2.10ext): decode of PNG, QOI
and PPM here (PNG through the standard library's zlib), other formats such
as JPEG textures through Pillow when it is installed, and PNG/QOI/PPM
encoders selected by output suffix (driver.c:839-874). QOI uses the native
C codec (raytracing_jax/native) when available, with a pure-Python
fallback.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def load_image_rgb_u8(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) u8."""
    with open(path, "rb") as f:
        return decode_image_rgb_u8(f.read())


def decode_image_rgb_u8(data: bytes) -> np.ndarray:
    """Decode an in-memory image (files, glTF bufferView images) to
    (H, W, 3) u8, dispatching on the format's magic bytes."""
    if data[:8] == _PNG_SIG:
        return png_decode(data)
    if data[:4] == b"qoif":
        return qoi_decode(data)
    if data[:2] == b"P6":
        return _ppm_decode(data)
    try:
        from PIL import Image
    except ImportError as e:
        kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "this image"
        raise ValueError(
            f"decoding a {kind} file needs Pillow, which is not installed "
            "(PNG, QOI and PPM decode without it)"
        ) from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


# ---------------------------------------------------------------------------
# PNG (zlib + the five scanline filters, PNG spec sections 9 and 11)
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by color type


def _unfilter_average(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 255


def _unfilter_paeth(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        if i >= bpp:
            a, c = line[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 255


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        pos = y * (stride + 1)
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum per channel
            cur = (
                np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
                % 256
            ).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            fn = _unfilter_average if kind == 3 else _unfilter_paeth
            fn(buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def png_decode(data: bytes) -> np.ndarray:
    """Decode a non-interlaced PNG to (H, W, 3) u8: grey, palette and alpha
    are expanded or dropped as Pillow's convert("RGB") does; 16-bit
    channels keep their high byte; 1/2/4-bit grey scales to 0-255."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: missing IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    sub_byte = depth in (1, 2, 4) and ctype in (0, 3)
    if interlace or ctype not in _PNG_CHANNELS or not (
        depth in (8, 16) or sub_byte
    ):
        raise ValueError(
            f"PNG: unsupported layout (bit depth {depth}, color type "
            f"{ctype}, interlace {interlace})"
        )
    ch = _PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    stride = (w * ch * depth + 7) // 8
    rows = _png_unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if sub_byte:
        bits = np.unpackbits(rows, axis=1)[:, : w * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        px = (bits.reshape(h, w, depth) * weights).sum(-1).astype(np.uint8)
        px = px[..., None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        px = rows.reshape(h, w, ch, depth // 8)[..., 0]  # 16-bit: high byte
    if ctype == 3:
        if plte is None:
            raise ValueError("PNG: palette image without PLTE")
        return plte[px[..., 0]]
    if ch <= 2:  # grey (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def png_encode(img: np.ndarray) -> bytes:
    """8-bit RGB PNG, every scanline with the Up filter."""
    h, w, _ = img.shape
    rows = np.ascontiguousarray(img, np.uint8).reshape(h, w * 3)
    raw = np.empty((h, w * 3 + 1), np.uint8)
    raw[:, 0] = 2
    raw[:, 1:] = rows
    raw[1:, 1:] -= rows[:-1]

    def chunk(tag: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(tag + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", crc
        )

    return b"".join([
        _PNG_SIG,
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        chunk(b"IEND", b""),
    ])


def _ppm_decode(data: bytes) -> np.ndarray:
    """Binary P6 with maxval 255 (what write_ppm writes)."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"PPM: unsupported maxval {maxval}")
    pos += 1
    return np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(h, w, 3)


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_encode(img))


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary P6 PPM."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def qoi_encode(img: np.ndarray) -> bytes:
    """QOI encode (spec: qoiformat.org). Tries the native C codec first."""
    from raytracing_jax.native import qoi_native

    enc = qoi_native()
    if enc is not None:
        return enc.encode(img)
    return _qoi_encode_py(img)


def qoi_decode(data: bytes) -> np.ndarray:
    from raytracing_jax.native import qoi_native

    dec = qoi_native()
    if dec is not None:
        return dec.decode(data)
    return _qoi_decode_py(data)


def write_qoi(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(qoi_encode(img))


def write_image(path: str, img: np.ndarray, warn=print) -> None:
    """Format dispatch by suffix with the reference's default-to-PNG warning
    (driver.c:839-851)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, img)
    elif ext == ".qoi":
        write_qoi(path, img)
    elif ext == ".ppm":
        write_ppm(path, img)
    else:
        warn(
            f"output format not recognized for output path '{path}', "
            "defaulting to png"
        )
        write_png(path, img)


# ---------------------------------------------------------------------------
# Pure-Python QOI (fallback; the native codec is the fast path)
# ---------------------------------------------------------------------------

_QOI_OP_INDEX = 0x00
_QOI_OP_DIFF = 0x40
_QOI_OP_LUMA = 0x80
_QOI_OP_RUN = 0xC0
_QOI_OP_RGB = 0xFE
_QOI_OP_RGBA = 0xFF


def _qoi_encode_py(img: np.ndarray) -> bytes:
    h, w, c = img.shape
    assert c == 3
    out = bytearray()
    out += b"qoif"
    out += w.to_bytes(4, "big") + h.to_bytes(4, "big")
    out += bytes([3, 0])  # channels, colorspace=sRGB

    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    flat = img.reshape(-1, 3)
    for px in flat:
        cur = (int(px[0]), int(px[1]), int(px[2]), 255)
        if cur == prev:
            run += 1
            if run == 62:
                out.append(_QOI_OP_RUN | (run - 1))
                run = 0
            continue
        if run:
            out.append(_QOI_OP_RUN | (run - 1))
            run = 0
        hidx = (cur[0] * 3 + cur[1] * 5 + cur[2] * 7 + cur[3] * 11) % 64
        if index[hidx] == cur:
            out.append(_QOI_OP_INDEX | hidx)
        else:
            index[hidx] = cur
            dr = (cur[0] - prev[0]) & 0xFF
            dg = (cur[1] - prev[1]) & 0xFF
            db = (cur[2] - prev[2]) & 0xFF
            dr = dr - 256 if dr > 127 else dr
            dg = dg - 256 if dg > 127 else dg
            db = db - 256 if db > 127 else db
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(
                    _QOI_OP_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
                )
            else:
                dr_dg = dr - dg
                db_dg = db - dg
                if -32 <= dg <= 31 and -8 <= dr_dg <= 7 and -8 <= db_dg <= 7:
                    out.append(_QOI_OP_LUMA | (dg + 32))
                    out.append(((dr_dg + 8) << 4) | (db_dg + 8))
                else:
                    out.append(_QOI_OP_RGB)
                    out += bytes(cur[:3])
        prev = cur
    if run:
        out.append(_QOI_OP_RUN | (run - 1))
    out += b"\x00" * 7 + b"\x01"
    return bytes(out)


def _qoi_decode_py(data: bytes) -> np.ndarray:
    assert data[:4] == b"qoif"
    w = int.from_bytes(data[4:8], "big")
    h = int.from_bytes(data[8:12], "big")
    pos = 14
    out = np.zeros((w * h, 3), np.uint8)
    index = [(0, 0, 0, 0)] * 64
    px = (0, 0, 0, 255)
    i = 0
    while i < w * h:
        b0 = data[pos]
        pos += 1
        if b0 == _QOI_OP_RGB:
            px = (data[pos], data[pos + 1], data[pos + 2], px[3])
            pos += 3
        elif b0 == _QOI_OP_RGBA:
            px = tuple(data[pos : pos + 4])
            pos += 4
        elif (b0 & 0xC0) == _QOI_OP_INDEX:
            px = index[b0 & 0x3F]
        elif (b0 & 0xC0) == _QOI_OP_DIFF:
            dr = ((b0 >> 4) & 3) - 2
            dg = ((b0 >> 2) & 3) - 2
            db = (b0 & 3) - 2
            px = ((px[0] + dr) & 255, (px[1] + dg) & 255, (px[2] + db) & 255, px[3])
        elif (b0 & 0xC0) == _QOI_OP_LUMA:
            dg = (b0 & 0x3F) - 32
            b1 = data[pos]
            pos += 1
            dr = dg + ((b1 >> 4) & 0xF) - 8
            db = dg + (b1 & 0xF) - 8
            px = ((px[0] + dr) & 255, (px[1] + dg) & 255, (px[2] + db) & 255, px[3])
        elif (b0 & 0xC0) == _QOI_OP_RUN:
            run = (b0 & 0x3F) + 1
            out[i : i + run] = px[:3]
            i += run
            continue
        hidx = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
        index[hidx] = px
        out[i] = px[:3]
        i += 1
    return out.reshape(h, w, 3)
