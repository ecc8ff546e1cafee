"""The port's own image files: PNG in and out, JPEG and GIF out.

Standard library (``zlib``, ``struct``), numpy and one host C++ routine, so
the CLI, the render service and the scene maker need neither Pillow nor
imageio.

- ``read_png``: 8-bit PNGs of colour types 0 (gray), 2 (RGB), 3 (palette,
  expanded to RGB, or RGBA where a ``tRNS`` chunk gives alpha), 4 (gray and
  alpha) and 6 (RGBA); every filter type; each chunk's CRC checked. An
  interlaced (Adam7) file and any bit depth other than 8 are refused by name.
  Sub, Average and Paeth unfiltering read the byte to the left, already
  reconstructed, so the unfilter is one sequential pass a row, in C++
  (``csrc/png_unfilter.cpp``, built with g++ at first use by
  ``data/native.py``); zlib inflates the rows.
- ``png_header`` / ``png_size``: the IHDR chunk alone.
- ``write_png``: gray, RGB or RGBA at 8 bits, each row's
  filter chosen by the minimum sum of absolute differences (libpng's rule).
- ``write_jpeg``: baseline sequential JFIF, gray or YCbCr 4:4:4, the ITU
  T.81 Annex K quantisation and Huffman tables with the quantisation scaled
  by libjpeg's quality rule; the entropy coding is vectorised.
- ``write_gif``: GIF89a, a NETSCAPE2.0 loop, one global 256-entry palette
  (6 x 7 x 6 uniform levels, each pixel to its nearest) and variable-width
  LZW (9 to 12 bits, a clear code when the table is full).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from tinynerf_torch.data import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type (at 8 bits)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_CRITICAL = {b"IHDR", b"PLTE", b"IDAT", b"IEND"}


class PngHeader(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


# ---------------------------------------------------------------- PNG in

def _chunks(data: bytes, path: str) -> Iterator[Tuple[bytes, bytes]]:
    """(type, body) of each chunk up to IEND, every CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            break
        body = data[pos + 8:end]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{path}: CRC mismatch in the {ctype.decode('latin-1')} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _parse_ihdr(body: bytes, path: str) -> PngHeader:
    if len(body) != 13:
        raise ValueError(f"{path}: malformed IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    return PngHeader(width, height, depth, ctype, interlace)


def png_header(path: str) -> PngHeader:
    """The IHDR chunk of the PNG at ``path`` (its CRC checked)."""
    with open(path, "rb") as f:
        data = f.read(8 + 8 + 13 + 4)
    ctype, body = next(_chunks(data, path))
    if ctype != b"IHDR":
        raise ValueError(f"{path}: the first chunk is not IHDR")
    return _parse_ihdr(body, path)


def png_size(path: str) -> Tuple[int, int]:
    """``(width, height)`` of the PNG at ``path``, as Pillow's ``Image.size``."""
    header = png_header(path)
    return header.width, header.height


def _check_supported(header: PngHeader, path: str) -> None:
    if header.interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not supported")
    if header.bit_depth != 8:
        raise ValueError(f"{path}: PNG bit depth {header.bit_depth} is not supported "
                         "(only 8 bits per sample)")


def _unfilter(rows: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Reconstruct (H, 1 + W * bpp) filtered rows, each led by its filter
    type byte, as an (H, W, bpp) uint8 array (``csrc/png_unfilter.cpp``)."""
    rows = np.ascontiguousarray(rows)
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, stride // bpp, bpp), np.uint8)
    bad = native.load_png_library().png_unfilter(rows.ctypes.data, height, stride, bpp,
                                                out.ctypes.data)
    if bad >= 0:
        raise ValueError(f"{path}: unknown PNG filter type {int(rows[bad, 0])} in row {bad}")
    return out


def read_png(path: str) -> np.ndarray:
    """The 8-bit PNG at ``path`` as (H, W, C) uint8: C = 1 (gray), 2 (gray
    and alpha), 3 (RGB) or 4 (RGBA); a palette file expanded through its
    palette to RGB, or to RGBA where it has a ``tRNS`` chunk. A ``tRNS``
    colour key of a gray or RGB file is ignored, as Pillow's RGB conversion
    ignores it. Interlaced files and other bit depths raise ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    header = palette = trns = None
    idat: List[bytes] = []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = _parse_ihdr(body, path)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype not in _CRITICAL and ctype[:1].isupper():
            raise ValueError(f"{path}: unknown critical chunk {ctype.decode('latin-1')}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    _check_supported(header, path)
    channels = _PNG_CHANNELS[header.color_type]
    stride = header.width * channels
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < header.height * (stride + 1):
        raise ValueError(f"{path}: image data too short for {header.width}x{header.height}")
    rows = np.frombuffer(raw, np.uint8, count=header.height * (stride + 1))
    rows = rows.reshape(header.height, stride + 1)
    pixels = _unfilter(rows, channels, path)
    if header.color_type != 3:
        return pixels
    if palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    index = pixels[..., 0]
    if index.size and int(index.max()) >= len(palette):
        raise ValueError(f"{path}: palette index beyond the PLTE chunk")
    rgb = palette[index]
    if trns is None:
        return rgb
    alpha = np.full(256, 255, np.uint8)
    alpha[:min(len(trns), 256)] = trns[:256]
    return np.concatenate([rgb, alpha[index][..., None]], axis=-1)


# ---------------------------------------------------------------- PNG out

def _as_u8_image(u8: np.ndarray, what: str) -> np.ndarray:
    image = np.asarray(u8)
    if image.dtype != np.uint8:
        raise ValueError(f"{what} takes uint8 pixels, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[0] == 0 or image.shape[1] == 0:
        raise ValueError(f"{what} takes an (H, W) or (H, W, C) image, got shape {image.shape}")
    return np.ascontiguousarray(image)


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filter_rows(x: np.ndarray, bpp: int) -> np.ndarray:
    """(H, S) bytes -> (H, 1 + S) filtered rows, each row's filter the one
    whose output has the least sum of absolute values as signed bytes. The
    filters read the unfiltered image, so every row is filtered at once."""
    x = x.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]) & 255
    cost = np.abs(cands.astype(np.uint8).view(np.int8).astype(np.int32)).sum(axis=2)
    best = np.argmin(cost, axis=0)
    rows = cands[best, np.arange(x.shape[0])].astype(np.uint8)
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def write_png(path: str, u8: np.ndarray) -> None:
    """Write (H, W) or (H, W, C) uint8, C = 1, 3 or 4, as an 8-bit PNG."""
    image = _as_u8_image(u8, "write_png")
    height, width, channels = image.shape
    if channels not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes gray, RGB or RGBA, got {channels} channels")
    ihdr = struct.pack(">IIBBBBB", width, height, 8, _PNG_COLOR_TYPE[channels], 0, 0, 0)
    rows = _filter_rows(image.reshape(height, width * channels), channels)
    data = (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------- JPEG out

# ITU T.81 Annex K.1 and K.2, in natural (row-major) order
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_QUANT = np.full(64, 99)
_CHROMA_QUANT.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                       [24, 26, 56, 99], [47, 66, 99, 99]]
# the natural index of each zigzag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# ITU T.81 Annex K.3: (code counts by length 1-16, symbols)
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa))
# the 8-point orthonormal DCT-II: F = D x D^T is T.81's FDCT of a block
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` and ``jpeg_add_quant_table`` with
    baseline forced: entries in [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol, as T.81 Annex C assigns them."""
    counts, symbols = table
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code = k = 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def _size_and_bits(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """T.81's magnitude category of each value and its extra bits (the value,
    or for a negative one its ones' complement in that many bits)."""
    size = np.frexp(np.abs(values).astype(np.float64))[1].astype(np.int64)
    bits = np.where(values < 0, values + (1 << size) - 1, values)
    return size, bits


def _entropy_code(coefs: np.ndarray, table_of_block: np.ndarray, tables) -> bytes:
    """Huffman-code quantised blocks (n, 64) in zigzag order, in their scan
    order, each with the tables ``tables[table_of_block[i]]`` = ((DC codes,
    lengths), (AC codes, lengths)); DC predicted per table, which here is
    per component (Cb and Cr share a table but not a predictor, so callers
    give them distinct table slots). Returns the byte-stuffed scan."""
    n = coefs.shape[0]
    keys: List[np.ndarray] = []
    codes: List[np.ndarray] = []
    lengths: List[np.ndarray] = []

    def emit(key, code, length):
        keys.append(key)
        codes.append(code)
        lengths.append(length)

    block = np.arange(n, dtype=np.int64)
    dc = coefs[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for t in np.unique(table_of_block):
        sel = np.flatnonzero(table_of_block == t)
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_code = np.stack([tables[t][0][0] for t in range(len(tables))])
    dc_len = np.stack([tables[t][0][1] for t in range(len(tables))])
    ac_code = np.stack([tables[t][1][0] for t in range(len(tables))])
    ac_len = np.stack([tables[t][1][1] for t in range(len(tables))])
    size, bits = _size_and_bits(diff)
    emit(block * 1024, dc_code[table_of_block, size], dc_len[table_of_block, size])
    emit(block * 1024 + 1, bits, size)

    b, p = np.nonzero(coefs[:, 1:])
    p = p + 1
    value = coefs[b, p].astype(np.int64)
    first = np.ones(b.shape, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], p[:-1]]))
    run = p - prev - 1
    t = table_of_block[b]
    zrl = run // 16
    if zrl.any():   # 16 zeros each: symbol 0xF0
        which = np.repeat(np.arange(b.size), zrl)
        within = np.arange(which.size) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        emit(b[which] * 1024 + p[which] * 8 + within, ac_code[t[which], 0xF0],
             ac_len[t[which], 0xF0])
    size, bits = _size_and_bits(value)
    symbol = (run % 16) * 16 + size
    emit(b * 1024 + p * 8 + 4, ac_code[t, symbol], ac_len[t, symbol])
    emit(b * 1024 + p * 8 + 5, bits, size)
    last = np.zeros(n, np.int64)
    ends = np.ones(b.shape, bool)
    ends[:-1] = b[1:] != b[:-1]
    last[b[ends]] = p[ends]   # each block's last nonzero AC position
    eob = np.flatnonzero(last < 63)
    emit(eob * 1024 + 512, ac_code[table_of_block[eob], 0x00], ac_len[table_of_block[eob], 0x00])

    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    code = np.concatenate(codes)[order]
    length = np.concatenate(lengths)[order]
    total = int(length.sum())
    item = np.repeat(np.arange(length.size), length)
    within = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    stream = ((code[item] >> (length[item] - 1 - within)) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-total % 8, np.uint8)])   # pad with 1 bits
    packed = np.packbits(stream)
    return np.insert(packed, np.flatnonzero(packed == 0xFF) + 1, 0).tobytes()


def write_jpeg(path: Optional[str], u8: np.ndarray, quality: int = 75) -> bytes:
    """Encode (H, W), (H, W, 1) or (H, W, 3) uint8 as a baseline JFIF JPEG,
    gray or YCbCr 4:4:4, at libjpeg's ``quality`` (75, imageio's default for
    a ``.jpg``); write it to ``path`` unless None, and return the bytes."""
    image = _as_u8_image(u8, "write_jpeg")
    height, width, channels = image.shape
    if channels not in (1, 3):
        raise ValueError(f"write_jpeg takes gray or RGB, got {channels} channels")
    pixels = image.astype(np.float64)
    if channels == 3:
        r, g, b = pixels[..., 0], pixels[..., 1], pixels[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    else:
        planes = [pixels[..., 0]]
    quants = [_quant_table(_LUMA_QUANT, quality), _quant_table(_CHROMA_QUANT, quality)]
    bh, bw = -(-height // 8), -(-width // 8)
    blocks = []
    for i, plane in enumerate(planes):
        plane = np.pad(plane, ((0, bh * 8 - height), (0, bw * 8 - width)), mode="edge") - 128.0
        tiles = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = (_DCT @ tiles @ _DCT.T).reshape(bh * bw, 64)
        q = quants[min(i, 1)]
        blocks.append((np.sign(coef) * np.floor(np.abs(coef) / q + 0.5)).astype(np.int64)[:, _ZIGZAG])
    # scan order: one MCU a block position, its components' blocks in turn
    coefs = np.stack(blocks, axis=1).reshape(-1, 64)
    component = np.tile(np.arange(len(planes)), bh * bw)
    luma = (_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA))
    chroma = (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))
    scan = _entropy_code(coefs, component, [luma, chroma, chroma][:len(planes)])

    n = len(planes)
    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\0" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0)),
           _marker(0xDB, b"".join(bytes([t]) + quants[t][_ZIGZAG].astype(np.uint8).tobytes()
                                  for t in range(min(n, 2)))),
           _marker(0xC0, struct.pack(">BHHB", 8, height, width, n)
                   + b"".join(bytes([i + 1, 0x11, min(i, 1)]) for i in range(n)))]
    for t, (dc, ac) in enumerate([(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)][:min(n, 2)]):
        out.append(_marker(0xC4, bytes([0x00 | t]) + bytes(dc[0]) + bytes(dc[1])
                           + bytes([0x10 | t]) + bytes(ac[0]) + bytes(ac[1])))
    out.append(_marker(0xDA, bytes([n]) + b"".join(bytes([i + 1, 0x11 * min(i, 1)])
                                                   for i in range(n)) + b"\x00\x3f\x00"))
    out += [scan, b"\xff\xd9"]
    data = b"".join(out)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


# ---------------------------------------------------------------- GIF out

_GIF_LEVELS = (6, 7, 6)   # R, G, B levels of the uniform palette: 252 colours


def _gif_palette() -> np.ndarray:
    r, g, b = (np.round(np.arange(n) * 255.0 / (n - 1)) for n in _GIF_LEVELS)
    grid = np.stack(np.meshgrid(r, g, b, indexing="ij"), axis=-1).reshape(-1, 3)
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(grid)] = grid
    return palette


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """Each pixel's nearest colour of the uniform palette (per channel)."""
    lv = np.array(_GIF_LEVELS)
    q = np.rint(frame.astype(np.float64) * (lv - 1) / 255.0).astype(np.int64)
    return (q[..., 0] * lv[1] * lv[2] + q[..., 1] * lv[2] + q[..., 2]).astype(np.uint8)


def _lzw(indices: bytes) -> bytes:
    """GIF LZW of 8-bit indices: codes from 9 to 12 bits, LSB first, a clear
    code first and whenever the 4096-entry table is full, an end code last.
    A code goes out at the width of the decoder's next free code, which
    trails the encoder's by the one entry the decoder adds late."""
    clear, end = 256, 257
    out_codes = [clear]
    out_widths = [9]
    table = {}
    next_code = 258
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        out_codes.append(prefix)
        out_widths.append((next_code - 1).bit_length())
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
        else:
            out_codes.append(clear)
            out_widths.append(12)
            table = {}
            next_code = 258
        prefix = k
    out_codes += [prefix, end]
    out_widths += [(next_code - 1).bit_length(), min(next_code.bit_length(), 12)]
    code = np.array(out_codes, np.int64)
    width = np.array(out_widths, np.int64)
    total = int(width.sum())
    item = np.repeat(np.arange(code.size), width)
    within = np.arange(total) - np.repeat(np.cumsum(width) - width, width)
    bits = ((code[item] >> within) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def write_gif(path: str, frames_u8: Sequence[np.ndarray], fps: float = 30) -> None:
    """Write (N, H, W, 3) uint8 frames as a looping GIF89a at ``fps`` (the
    delay rounded to hundredths of a second)."""
    frames = [_as_u8_image(f, "write_gif") for f in frames_u8]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    height, width = frames[0].shape[:2]
    delay = max(1, int(round(100.0 / fps)))
    out = [b"GIF89a", struct.pack("<HHBBB", width, height, 0xF7, 0, 0),
           _gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for frame in frames:
        if frame.shape != (height, width, 3):
            raise ValueError(f"write_gif takes RGB frames of one size, got {frame.shape}")
        data = _lzw(_gif_indices(frame).tobytes())
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0), b"\x08"]
        out += [bytes([len(data[i:i + 255])]) + data[i:i + 255]
                for i in range(0, len(data), 255)]
        out.append(b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))
