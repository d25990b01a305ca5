"""PNG reading and writing in numpy and zlib.

The JAX package decodes dataset frames with PIL
(`Image.open(path).convert("RGB")`); the port reads them with this module
on every machine, so it needs no imaging package. `read_png` takes 8-bit,
non-interlaced PNGs of each color type (gray, gray+alpha, RGB, RGBA,
palette) with filter types 0-4 and maps them to RGB as PIL's
`convert("RGB")` does: gray is replicated, alpha dropped, palette entries
looked up. Anything else (16-bit or sub-byte depths, interlacing, a bad
chunk CRC, a file that is not a PNG) raises ValueError naming the file.

`encode_png` / `write_png` write 8-bit gray, gray+alpha, RGB or RGBA
images with one filter type for every row (0 unless asked otherwise).
`write_apng` writes a sequence of such frames as one animated PNG (the
APNG chunks acTL / fcTL / fdAT), the port's video container; `read_apng`
reads every frame back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel (8-bit depth)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}          # samples a pixel -> color type


def _chunks(data: bytes, path: str):
    """(tag, payload) of every chunk, each CRC checked, up to IEND."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in PNG chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _average_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(line)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + prev[i]) >> 1)) & 255
    return out


def _paeth_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """(h, w*bpp) uint8 samples of the (h, 1 + w*bpp) filtered scanlines.
    None, Sub and Up are numpy operations on a row; Average and Paeth
    depend on the pixel to their left and go byte by byte."""
    out = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: a running sum of each channel, modulo 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype == 3:
            cur = np.frombuffer(_average_row(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _check_header(path: str, header, palette) -> None:
    """Raise ValueError for an IHDR (or a missing PLTE) that is not read."""
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: PNG bit depth {depth}; only 8-bit PNGs are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG; only non-interlaced PNGs are read")
    if color not in CHANNELS or compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unsupported PNG (color type {color}, compression "
                         f"{compression}, filter method {filtering})")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")


def _rgb(data: bytes, header, palette, path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of one image's zlib stream (the IDAT or fdAT
    payloads joined), mapped as PIL's convert("RGB")."""
    w, h, _, color = header[:4]
    bpp = CHANNELS[color]
    raw = zlib.decompress(data)
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, not "
                         f"{h * (1 + w * bpp)}")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp),
                   h, w, bpp, path).reshape(h, w, bpp)
    if color == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the {len(palette)}-entry PLTE")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _read(path: str) -> list:
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    return list(_chunks(data, path))


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit, non-interlaced PNG file, as PIL's
    `Image.open(path).convert("RGB")` gives it (of an animated PNG: its
    default image, the first frame as write_apng writes it)."""
    header, palette, idat = None, None, []
    for tag, body in _read(path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    _check_header(path, header, palette)
    return _rgb(b"".join(idat), header, palette, path)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] of a PNG frame: the JAX package's
    `(np.asarray(im.convert("RGB")) / 255.0).astype(np.float32)`."""
    return (read_png(path) / 255.0).astype(np.float32)


def _filter(px: np.ndarray, ftype: int) -> np.ndarray:
    """(h, w, c) uint8 samples -> (h, w*c) bytes of filter `ftype`."""
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"PNG filter type {ftype}: want 0-4")
    return ((x - pred) & 255).astype(np.uint8).reshape(px.shape[0], -1)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _samples(img: np.ndarray, what: str) -> np.ndarray:
    """An 8-bit (H, W) or (H, W, C) image as (H, W, C), C in 1-4."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    px = img[..., None] if img.ndim == 2 else img
    if px.ndim != 3 or px.shape[2] not in COLOR_TYPE:
        raise ValueError(f"{what}: want (H,W) or (H,W,C) with C in 1-4, got {img.shape}")
    return px


def _ihdr(px: np.ndarray) -> bytes:
    h, w, c = px.shape
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0))


def _zdata(px: np.ndarray, filter_type: int) -> bytes:
    """The zlib stream of an image's filtered scanlines."""
    rows = _filter(px, filter_type)
    raw = np.concatenate([np.full((px.shape[0], 1), filter_type, np.uint8), rows], 1)
    return zlib.compress(raw.tobytes(), 6)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """The PNG file of an 8-bit (H, W) gray or (H, W, C) image, C = 1 (gray),
    2 (gray+alpha), 3 (RGB) or 4 (RGBA), every row under `filter_type`."""
    px = _samples(img, "encode_png")
    return (SIGNATURE + _ihdr(px) + _chunk(b"IDAT", _zdata(px, filter_type))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an 8-bit (H, W) gray or (H, W, 3) RGB image (or C = 2, 4) as a
    PNG file, filter type 0."""
    data = encode_png(img)
    with open(path, "wb") as fh:
        fh.write(data)


def write_apng(path: str, frames: np.ndarray, fps: int = 15) -> None:
    """Write N 8-bit frames, (N, H, W) gray or (N, H, W, C), as one animated
    PNG (APNG) file: every frame full size, shown 1/fps s, looping forever,
    no disposal or blending. Frame 0 is also the default image (IDAT), so
    a reader without APNG support shows it; the rest are fdAT chunks."""
    frames = np.asarray(frames)
    if frames.ndim not in (3, 4) or len(frames) == 0:
        raise ValueError(f"write_apng: want N >= 1 frames (N,H,W[,C]), got {frames.shape}")
    px = [_samples(f, "write_apng") for f in frames]
    h, w, _ = px[0].shape
    out = [SIGNATURE, _ihdr(px[0]), _chunk(b"acTL", struct.pack(">II", len(px), 0))]
    seq = 0
    for i, p in enumerate(px):
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, fps, 0, 0)))
        seq += 1
        if i == 0:
            out.append(_chunk(b"IDAT", _zdata(p, 0)))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + _zdata(p, 0)))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def read_apng(path: str) -> np.ndarray:
    """(N, H, W, 3) uint8 RGB frames of an animated PNG whose frames all
    cover the whole image, as write_apng writes them (each mapped to RGB
    as read_png maps an image). A default image outside the animation is
    skipped; a partial frame raises ValueError."""
    header, palette, frames, cur = None, None, [], None
    for tag, body in _read(path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"fcTL":
            _, fw, fh, x, y = struct.unpack(">IIIII", body[:20])
            if header is None or (fw, fh, x, y) != (header[0], header[1], 0, 0):
                raise ValueError(f"{path}: APNG frame of {fw}x{fh} at ({x}, {y}); only "
                                 "full-image frames are read")
            cur = []
            frames.append(cur)
        elif tag == b"IDAT" and cur is not None:
            cur.append(body)
        elif tag == b"fdAT":
            if cur is None:
                raise ValueError(f"{path}: APNG fdAT chunk before any fcTL")
            cur.append(body[4:])
    _check_header(path, header, palette)
    if not frames:
        raise ValueError(f"{path}: not an animated PNG (no fcTL chunk)")
    return np.stack([_rgb(b"".join(f), header, palette, path) for f in frames])
