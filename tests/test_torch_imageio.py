"""The port's image codecs against the reference's.

EXR (half and float, ZIP and uncompressed) and PFM files written by the port
must equal the reference's byte for byte and read back to the same arrays;
Radiance HDR files (flat and run-length-encoded scanlines, written here)
must decode to the same arrays. The port reads and writes 8-bit PNG without
PIL: its PNG must decode (with PIL, here in the test only) to the
reference's pixels, and PNGs that PIL writes (several row filters, 1-bit and
8-bit gray, gray + alpha, RGB, RGBA, 2- and 4-bit palettes) must read to the
reference's linear values.
"""
import numpy as np
import pytest
from PIL import Image

from pbrt_tpu.core import imageio as ref_io
from pbrt_tpu_torch.core import imageio as io


def _image(h=19, w=23, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.lognormal(size=(h, w, 3)).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = 6.0e4  # near half's largest finite value
    return img


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("compress", [True, False])
def test_exr_bytes_and_arrays_equal(tmp_path, half, compress):
    img = _image(37)  # 3 ZIP chunks of 16 rows, the last short
    io.write_exr(str(tmp_path / "p.exr"), img, half=half, compress=compress)
    ref_io.write_exr(str(tmp_path / "r.exr"), img, half=half, compress=compress)
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "r.exr").read_bytes()
    got = io.read_exr(str(tmp_path / "r.exr"))
    np.testing.assert_array_equal(got, ref_io.read_exr(str(tmp_path / "r.exr")))
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got, want)


def test_pfm_and_write_image_equal(tmp_path):
    img = _image()
    for ext in ("pfm", "exr"):
        io.write_image(str(tmp_path / f"p.{ext}"), img)
        ref_io.write_image(str(tmp_path / f"r.{ext}"), img)
        assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"r.{ext}").read_bytes()
        np.testing.assert_array_equal(io.read_image(str(tmp_path / f"r.{ext}")),
                                      ref_io.read_image(str(tmp_path / f"r.{ext}")))
    np.testing.assert_array_equal(io.read_image(str(tmp_path / "p.pfm")), img)


def _write_hdr(path, rgbe, rle_rows):
    """Radiance RGBE file; the rows in rle_rows use new-style run-length
    scanlines (runs and literals), the others flat RGBE."""
    h, w, _ = rgbe.shape
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        if y not in rle_rows:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            plane = rgbe[y, :, c]
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and plane[x + run] == plane[x]:
                    run += 1
                if run > 2:
                    out += bytes([128 + run, plane[x]])
                    x += run
                else:
                    n = min(2, w - x)
                    out += bytes([n]) + plane[x:x + n].tobytes()
                    x += n
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_hdr_reads_equal(tmp_path):
    rs = np.random.RandomState(1)
    h, w = 6, 40
    rgbe = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, 10:30] = rgbe[:, 10:11]  # runs
    rgbe[2, :, 3] = 0  # zero exponents
    _write_hdr(tmp_path / "a.hdr", rgbe, rle_rows={1, 3, 4})
    got = io.read_image(str(tmp_path / "a.hdr"))
    want = ref_io.read_image(str(tmp_path / "a.hdr"))
    assert got.shape == (h, w, 3) and got[1:].max() > 0
    np.testing.assert_array_equal(got, want)


def test_png_written_decodes_to_reference_pixels(tmp_path):
    img = _image() * 0.3
    io.write_image(str(tmp_path / "p.png"), img)
    ref_io.write_image(str(tmp_path / "r.png"), img)
    got = np.asarray(Image.open(tmp_path / "p.png"))
    want = np.asarray(Image.open(tmp_path / "r.png"))
    assert got.dtype == np.uint8 and got.shape == (19, 23, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P2", "1"])
def test_png_read_matches_reference(tmp_path, mode):
    rs = np.random.RandomState(2)
    h, w = 21, 33
    smooth = np.cumsum(rs.randint(0, 9, (h, w, 4)), axis=1).astype(np.uint8)  # PIL picks several filters
    noisy = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    img = np.concatenate([smooth, noisy], axis=0)
    if mode.startswith("P"):  # 16 colours: 4-bit indices; 4 colours: 2-bit
        pil = Image.fromarray(img[..., :3]).quantize(16 if mode == "P" else 4)
    else:
        pil = Image.fromarray(img).convert(mode)
    path = str(tmp_path / f"{mode}.png")
    pil.save(path)
    np.testing.assert_array_equal(io.read_png(path), np.asarray(Image.open(path).convert("RGB")))
    for gamma in (None, False):
        np.testing.assert_array_equal(io.read_image(path, gamma=gamma), ref_io.read_image(path, gamma=gamma))


def test_png_filters_all_decoded(tmp_path):
    """A PNG whose rows use several of the five filters (PIL's adaptive
    choice per row) reads to its own pixels."""
    rs = np.random.RandomState(3)
    x = np.arange(64)
    img = np.stack([(x[None, :] * 3 + x[:, None] * 5) % 256, rs.randint(0, 256, (64, 64)),
                    (x[None, :] ^ x[:, None]) * 4 % 256], -1).astype(np.uint8)
    path = str(tmp_path / "f.png")
    Image.fromarray(img).save(path, optimize=True)
    data = _idat_filters(path, 64, 3)
    assert len(set(data)) >= 3, data
    np.testing.assert_array_equal(io.read_png(path), img)


def _idat_filters(path, w, c):
    import struct
    import zlib

    buf = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        if buf[pos + 4:pos + 8] == b"IDAT":
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return [raw[i] for i in range(0, len(raw), w * c + 1)]


@pytest.mark.parametrize("ext", [".jpg", ".tga", ".bmp"])
def test_other_ldr_formats_raise(tmp_path, ext):
    with pytest.raises(NotImplementedError, match=ext):
        io.write_image(str(tmp_path / f"x{ext}"), _image())
    with pytest.raises(NotImplementedError, match=ext):
        io.read_image(str(tmp_path / f"x{ext}"))
