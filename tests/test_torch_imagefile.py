"""The port's own image files (``tinynerf_torch/data/imagefile.py``) against
Pillow: PNG decoding bit for bit on the files Pillow writes and on
hand-built files of every filter type; the image loader's pixels equal to
the Pillow path it replaced; PNGs Pillow decodes bit-equal; JPEGs Pillow
decodes, as close to the source as Pillow's own encoding; GIFs Pillow
reads."""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from tinynerf_torch.data import imagefile, poses
from tinynerf_torch.tools import make_synthetic_scene as maker

H, W = 11, 13   # a width no multiple of 8


def _images(seed: int):
    """A smooth and a noise image, (H, W, 4) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([xx * 19, yy * 23, (xx + yy) * 9, 255 - xx * yy], -1) % 256
    return smooth.astype(np.uint8), rng.integers(0, 256, (H, W, 4), dtype=np.uint8)


def _pillow_files(tmp_path):
    """{name: path} of PNGs Pillow writes: L, LA, RGB, RGBA, P, P with
    transparency (a 256-entry palette: 8-bit indices)."""
    smooth, noise = _images(0)
    files = {}
    for mode, sl in (("L", [0]), ("LA", [0, 3]), ("RGB", [0, 1, 2]), ("RGBA", [0, 1, 2, 3])):
        for kind, img in (("smooth", smooth), ("noise", noise)):
            path = str(tmp_path / f"{kind}_{mode}.png")
            Image.fromarray(np.ascontiguousarray(img[..., sl].squeeze(-1) if mode == "L"
                                                 else img[..., sl]), mode).save(path)
            files[f"{kind}_{mode}"] = path
    rng = np.random.default_rng(1)
    pal = Image.fromarray(rng.integers(0, 256, (H, W), dtype=np.uint8), "P")
    pal.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    files["P"] = str(tmp_path / "p.png")
    pal.save(files["P"])
    files["P_trns"] = str(tmp_path / "p_trns.png")
    pal.save(files["P_trns"], transparency=rng.integers(0, 256, 256, dtype=np.uint8).tobytes())
    return files


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _hand_png(pixels: np.ndarray, filters, interlace=0, depth=8) -> bytes:
    """An 8-bit PNG of ``pixels`` (H, W, C) whose row r uses filter type
    ``filters[r % len(filters)]``, filtered here byte by byte as the PNG
    specification states it."""
    h, w, ch = pixels.shape
    x = pixels.reshape(h, w * ch).astype(int)
    raw = bytearray()
    for r in range(h):
        ft = filters[r % len(filters)]
        raw.append(ft)
        for i in range(w * ch):
            a = x[r, i - ch] if i >= ch else 0
            b = x[r - 1, i] if r else 0
            c = x[r - 1, i - ch] if r and i >= ch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            raw.append((x[r, i] - pred) % 256)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (imagefile.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b""))


def _hand_files(tmp_path):
    """{name: path} of hand-built PNGs: each filter type alone and all five
    mixed, in gray, gray and alpha, RGB and RGBA."""
    smooth, noise = _images(2)
    files = {}
    for filters in ([0], [1], [2], [3], [4], [4, 3, 1, 0, 2]):
        for ch, img in ((1, smooth), (2, noise), (3, smooth), (4, noise)):
            path = tmp_path / f"f{''.join(map(str, filters))}_{ch}.png"
            path.write_bytes(_hand_png(img[..., :ch], filters))
            files[path.stem] = str(path)
    return files


def _pillow_load_image(path: str, white_composite: bool) -> np.ndarray:
    """The loader's image path before it read PNGs itself, kept verbatim."""
    image = Image.open(path)
    image.load()
    if white_composite and image.mode == "RGBA":
        background = Image.new("RGB", image.size, (255, 255, 255))
        background.paste(image, mask=image.split()[3])
        image = background
    else:
        image = image.convert("RGB")
    return np.asarray(image, dtype=np.float32) / 255.0


PILLOW_KINDS = ["smooth_L", "noise_L", "smooth_LA", "noise_LA", "smooth_RGB", "noise_RGB",
                "smooth_RGBA", "noise_RGBA", "P", "P_trns"]


@pytest.mark.parametrize("name", PILLOW_KINDS)
def test_read_png_equals_pillow_on_files_pillow_writes(tmp_path, name):
    """Gray, gray and alpha, RGB, RGBA as Pillow decodes them; a palette file
    as Pillow's RGB conversion, with transparency as its RGBA conversion."""
    path = _pillow_files(tmp_path)[name]
    img = Image.open(path)
    want = np.asarray(img.convert("RGBA") if name == "P_trns" else
                      img.convert("RGB") if name == "P" else img)
    got = imagefile.read_png(path)
    want = want[..., None] if want.ndim == 2 else want
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert imagefile.png_size(path) == img.size == (W, H)


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "43102"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_unfilters_every_filter_type(tmp_path, filters, channels):
    """Hand-built files: each filter type alone and all five mixed, at 1 to
    4 bytes a pixel, equal to the source pixels and to Pillow's decode."""
    path = _hand_files(tmp_path)[f"f{filters}_{channels}"]
    got = imagefile.read_png(path)
    source = _images(2)[channels % 2 == 0][..., :channels]
    np.testing.assert_array_equal(got, source)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)).reshape(source.shape))


def test_read_png_refuses_an_unknown_filter_type(tmp_path):
    """A row whose filter type byte is not 0-4 is refused, naming the type
    and the row."""
    data = bytearray(_hand_png(_images(3)[0][..., :3], [1]))
    idat = data.index(b"IDAT")
    length = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = bytearray(zlib.decompress(bytes(data[idat + 4:idat + 4 + length])))
    raw[2 * (1 + 3 * W)] = 7   # row 2's filter type
    path = tmp_path / "filter7.png"
    path.write_bytes(imagefile.PNG_SIGNATURE + bytes(data[8:idat - 4])
                     + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unknown PNG filter type 7 in row 2"):
        imagefile.read_png(str(path))


@pytest.mark.parametrize("white_composite", [True, False])
@pytest.mark.parametrize("name", PILLOW_KINDS + ["f43102_3", "f43102_4", "f4_4"])
def test_load_image_equals_the_pillow_path(tmp_path, name, white_composite):
    """``poses._load_image`` equals the Pillow path it replaced, bit for bit:
    only RGBA is composited onto white; gray and alpha, and a palette with
    transparency, are converted to RGB without it."""
    files = {**_pillow_files(tmp_path), **_hand_files(tmp_path)}
    got = poses._load_image(files[name], white_composite)
    want = _pillow_load_image(files[name], white_composite)
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,match", [("interlaced", "interlaced \\(Adam7\\)"),
                                        ("16-bit", "bit depth 16"),
                                        ("crc", "CRC mismatch in the IDAT chunk")])
def test_read_png_refuses_by_name(tmp_path, kind, match):
    """An interlaced file, a 16-bit file (as Pillow writes one) and a file
    with a corrupt chunk are refused, naming what is wrong."""
    path = tmp_path / f"{kind}.png"
    smooth = _images(3)[0][..., :3]
    if kind == "interlaced":
        path.write_bytes(_hand_png(smooth, [0], interlace=1))
    elif kind == "16-bit":
        Image.fromarray(smooth[..., 0].astype(np.uint16) * 257).save(path)
        assert imagefile.png_header(str(path)).bit_depth == 16
    else:
        data = bytearray(_hand_png(smooth, [1]))
        data[60] ^= 0x40   # a byte of the IDAT body
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match):
        imagefile.read_png(str(path))


def test_load_image_names_pillow_for_other_files(tmp_path, monkeypatch):
    """A file that is not a PNG (an LLFF ``.JPG``) is read through Pillow;
    without Pillow the loader raises, naming Pillow and the file."""
    path = str(tmp_path / "IMG_0001.JPG")
    Image.fromarray(_images(4)[0][..., :3]).save(path, "JPEG")
    assert poses._load_image(path, False).shape == (H, W, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError) as exc:
        poses._load_image(path, False)
    assert "Pillow" in str(exc.value) and path in str(exc.value)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_decodes_bit_equal_in_pillow(tmp_path, channels):
    """Gray, RGB and RGBA round-trip through Pillow bit for bit, and through
    ``read_png``."""
    for img in _images(5):
        src = img[..., :channels]
        path = str(tmp_path / f"w{channels}.png")
        imagefile.write_png(path, src[..., 0] if channels == 1 else src)
        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back.reshape(src.shape), src)
        np.testing.assert_array_equal(imagefile.read_png(path), src)


def _mse(a, b) -> float:
    return float(np.mean((a.astype(np.float64) - b) ** 2))


# the port's JPEG against the source may have at most this much more squared
# error than Pillow's own 4:4:4 encoding at the same quality: both quantise
# the same DCT coefficients with the same Annex K tables, scaled alike, and
# only libjpeg's integer DCT and its 8-bit rounding of YCbCr differ, a few
# hundredths of a dB (a factor 1.06 is 0.25 dB); where the coding error is
# under one level (PSNR above about 50 dB) the decoder's rounding of each
# pixel to a level dominates it, and two encoders' sub-level errors round
# apart by a few hundredths of a level squared (JPEG_MSE_ABS)
JPEG_MSE_RATIO = 1.06
JPEG_MSE_ABS = 0.05


@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("gray", [False, True])
def test_write_jpeg_decodes_in_pillow(tmp_path, quality, gray):
    """Pillow decodes ``write_jpeg`` (baseline, JFIF, gray or YCbCr 4:4:4)
    at its size and mode, and on a smooth image and a scene view its squared
    error against the source is within JPEG_MSE_RATIO and JPEG_MSE_ABS of
    Pillow's own 4:4:4 JPEG's at the same quality, or below it."""
    yy, xx = np.mgrid[0:96, 0:120]
    smooth = np.stack([128 + 100 * np.sin(xx / 17), 128 + 90 * np.cos(yy / 13),
                       (xx + 2 * yy) % 256], -1).astype(np.uint8)
    rgba = maker.render_view(maker.look_at(np.array([1.5, 1.2, 3.5])), 96)
    alpha = rgba[..., 3:].astype(np.float64) / 255
    view = (rgba[..., :3] * alpha + 255 * (1 - alpha)).astype(np.uint8)
    for src in (smooth, view):
        src = src[..., 1] if gray else src
        path = str(tmp_path / "x.jpg")
        data = imagefile.write_jpeg(path, src, quality)
        assert data == open(path, "rb").read() and data[:2] == b"\xff\xd8"
        img = Image.open(io.BytesIO(data))
        assert img.format == "JPEG" and img.mode == ("L" if gray else "RGB")
        assert img.size == (src.shape[1], src.shape[0])
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "JPEG", quality=quality, subsampling=0)
        ours, pillow = (_mse(np.asarray(Image.open(io.BytesIO(d))), src)
                        for d in (data, buf.getvalue()))
        assert ours <= JPEG_MSE_RATIO * pillow + JPEG_MSE_ABS, (ours, pillow)
        assert 10 * np.log10(255.0 ** 2 / ours) > 30.0


def test_write_gif_reads_in_pillow(tmp_path):
    """Pillow reads ``write_gif``'s frame count, size, loop and delay, and
    its frames are the uniform palette's nearest colours exactly: noise
    frames fill the 4096-entry LZW table, so its clear codes are read too."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (3, 70, 90, 3), dtype=np.uint8)
    frames[1] = np.repeat(np.arange(90, dtype=np.uint8)[None, :, None] * 2, 70, axis=0)
    path = str(tmp_path / "v.gif")
    imagefile.write_gif(path, frames, fps=25)
    img = Image.open(path)
    assert img.n_frames == 3 and img.size == (90, 70)
    assert img.info["loop"] == 0 and img.info["duration"] == 40
    palette = imagefile._gif_palette()
    for i in range(3):
        img.seek(i)
        want = palette[imagefile._gif_indices(frames[i])]
        np.testing.assert_array_equal(np.asarray(img.convert("RGB")), want)
        assert np.abs(want.astype(int) - frames[i]).max() <= 26   # half the coarsest level step
