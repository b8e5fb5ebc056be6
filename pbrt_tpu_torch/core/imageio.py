"""Image I/O: OpenEXR (scanline, NONE/ZIP/ZIPS), Radiance HDR/RGBE, PNG/LDR.

Replaces the reference's use of the `exr` and `image` crates
(src/core/imageio.rs).  The EXR codec here is written from
the OpenEXR file-format spec: little-endian header of named attributes, a
scanline offset table, and per-chunk pixel data; ZIP chunks are zlib streams
over a delta-predictor + two-way byte interleave.  The HDR reader implements
the Radiance RGBE format including new-style RLE scanlines.  8-bit PNG (gray,
gray + alpha, RGB, RGBA and palette, non-interlaced) is read and written
here with zlib and struct, with sRGB <-> linear conversion (imageio.rs gamma
handling).

The port's copy of ``pbrt_tpu/core/imageio.py``. The reference decodes and
encodes 8-bit formats through PIL, which the port does not use: PNG has its
own codec below, and every other 8-bit format raises NotImplementedError
naming its extension.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# OpenEXR
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIXELTYPE_UINT = 0
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2
_COMPRESSION_NONE = 0
_COMPRESSION_RLE = 1
_COMPRESSION_ZIPS = 2  # 1 scanline / chunk
_COMPRESSION_ZIP = 3  # 16 scanlines / chunk
_ZIP_BLOCK = {_COMPRESSION_NONE: 1, _COMPRESSION_RLE: 1, _COMPRESSION_ZIPS: 1, _COMPRESSION_ZIP: 16}


def _read_cstring(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _exr_reconstruct(data: bytes) -> bytes:
    """Invert the ZIP predictor: stored[0]=raw[0], stored[i]=raw[i]-raw[i-1]+128
    (mod 256), so raw[i] = (cumsum(stored)[i] - 128*i) mod 256."""
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    raw = (np.cumsum(arr) - 128 * np.arange(len(arr))) % 256
    return raw.astype(np.uint8).tobytes()


def _exr_predictor(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    d = np.empty_like(arr)
    d[0] = arr[0]
    d[1:] = (arr[1:] - arr[:-1] + 128) % 256
    return d.astype(np.uint8).tobytes()


def _exr_deinterleave(data: bytes) -> bytes:
    """Undo the two-way split: first half = even bytes, second half = odd."""
    n = len(data)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    out[0::2] = src[:half]
    out[1::2] = src[half:]
    return out.tobytes()


def _exr_interleave(data: bytes) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    n = len(src)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[:half] = src[0::2]
    out[half:] = src[1::2]
    return out.tobytes()


def _rle_decompress(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            cnt = -count
            out += data[i : i + cnt]
            i += cnt
        else:
            out += data[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path):
    """Read a scanline EXR -> (H, W, 3) float32 RGB (+ alpha dropped)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8
    channels = []
    compression = _COMPRESSION_NONE
    data_window = None
    while True:
        name, pos = _read_cstring(buf, pos)
        if name == "":
            break
        atype, pos = _read_cstring(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        val = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cname, cpos = _read_cstring(val, cpos)
                ptype, _plin, xs, ys = struct.unpack_from("<iiii", val, cpos)
                cpos += 16
                if xs != 1 or ys != 1:
                    raise ValueError(f"{path}: subsampled channels not supported")
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", val)
    if data_window is None:
        raise ValueError(f"{path}: missing dataWindow")
    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    if compression not in _ZIP_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")
    block = _ZIP_BLOCK[compression]
    nchunks = (height + block - 1) // block
    offsets = struct.unpack_from(f"<{nchunks}q", buf, pos)

    # channels are stored alphabetically; each scanline has all channels
    ch_dtypes = [np.uint32 if t == _PIXELTYPE_UINT else (np.float16 if t == _PIXELTYPE_HALF else np.float32) for _, t in channels]
    ch_sizes = [np.dtype(d).itemsize for d in ch_dtypes]
    planes = {name: np.zeros((height, width), dtype=np.float32) for name, _ in channels}

    for ci, off in enumerate(offsets):
        y0, size = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8 : off + 8 + size]
        rows = min(block, ymax - y0 + 1)
        expected = rows * width * sum(ch_sizes)
        if compression in (_COMPRESSION_ZIP, _COMPRESSION_ZIPS):
            if size < expected:
                raw = _exr_deinterleave(_exr_reconstruct(zlib.decompress(raw)))
            # else: stored uncompressed because zip didn't shrink it
        elif compression == _COMPRESSION_RLE:
            if size < expected:
                raw = _exr_deinterleave(_exr_reconstruct(_rle_decompress(raw, expected)))
        rpos = 0
        for r in range(rows):
            y = y0 - ymin + r
            for (cname, _t), dt, csz in zip(channels, ch_dtypes, ch_sizes):
                row = np.frombuffer(raw, dtype=dt, count=width, offset=rpos)
                planes[cname][y] = row.astype(np.float32)
                rpos += width * csz
    if all(c in planes for c in "RGB"):
        img = np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    elif "Y" in planes:
        img = np.repeat(planes["Y"][..., None], 3, axis=-1)
    else:
        first = next(iter(planes.values()))
        img = np.repeat(first[..., None], 3, axis=-1)
    return np.ascontiguousarray(img, dtype=np.float32)


def write_exr(path, rgb, half=True, compress=True):
    """Write (H, W, 3) float RGB as a scanline EXR (ZIP or NONE)."""
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w, _ = rgb.shape
    ptype = _PIXELTYPE_HALF if half else _PIXELTYPE_FLOAT
    dt = np.float16 if half else np.float32
    compression = _COMPRESSION_ZIP if compress else _COMPRESSION_NONE
    block = _ZIP_BLOCK[compression]

    def attr(name, atype, val):
        return name.encode() + b"\x00" + atype.encode() + b"\x00" + struct.pack("<i", len(val)) + val

    chan = b""
    for cname in ("B", "G", "R"):  # alphabetical order, as required
        chan += cname.encode() + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chan += b"\x00"
    header = b""
    header += attr("channels", "chlist", chan)
    header += attr("compression", "compression", bytes([compression]))
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += attr("dataWindow", "box2i", dw)
    header += attr("displayWindow", "box2i", dw)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    bgr = rgb[:, :, ::-1].astype(dt)  # B, G, R planes per scanline
    chunks = []
    for y0 in range(0, h, block):
        rows = min(block, h - y0)
        raw = b"".join(bgr[y0 + r, :, c].tobytes() for r in range(rows) for c in range(3))
        if compression == _COMPRESSION_ZIP:
            comp = zlib.compress(_exr_predictor(_exr_interleave(raw)))
            if len(comp) >= len(raw):
                comp = raw
        else:
            comp = raw
        chunks.append((y0, comp))

    base = 8 + len(header) + 8 * len(chunks)
    out = bytearray()
    out += struct.pack("<ii", _EXR_MAGIC, 2)
    out += header
    off = base
    for y0, comp in chunks:
        out += struct.pack("<q", off)
        off += 8 + len(comp)
    for y0, comp in chunks:
        out += struct.pack("<ii", y0, len(comp))
        out += comp
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# Radiance HDR (RGBE)
# ---------------------------------------------------------------------------


def read_hdr(path):
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].decode().split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"{path}: unsupported HDR orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 and ((data[pos + 2] << 8) | data[pos + 3]) == w:
            pos += 4  # new-style RLE: 4 component planes
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x : x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x : x + cnt, c] = np.frombuffer(data, np.uint8, cnt, pos)
                        pos += cnt
                        x += cnt
        else:  # flat scanline
            row = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4
    exp = rgbe[:, :, 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[:, :, :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(exp[..., None] == 0, 0.0, 1.0)


# ---------------------------------------------------------------------------
# sRGB helpers + unified entry points (reference imageio.rs:18-115)
# ---------------------------------------------------------------------------


def srgb_to_linear(c):
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = np.asarray(c, dtype=np.float32)
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def read_image(path, gamma=None):
    """Read any supported image as linear float32 (H, W, 3).

    gamma: None = auto (LDR formats decoded sRGB->linear, HDR passed through),
    True/False forces the conversion on/off (pbrt imagemap 'gamma' param).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext in (".hdr", ".pic", ".rgbe"):
        return read_hdr(path)
    if ext == ".pfm":
        return _read_pfm(path)
    if ext != ".png":
        raise NotImplementedError(f"pbrt_tpu_torch does not read '{ext}' images (PIL-only in the reference)")
    img = read_png(path).astype(np.float32) / 255.0
    if gamma is None or gamma:
        img = srgb_to_linear(img)
    return img


def write_image(path, rgb):
    """Write linear RGB to EXR (as-is) or an LDR format (sRGB-encoded)."""
    ext = os.path.splitext(path)[1].lower()
    rgb = np.asarray(rgb, dtype=np.float32)
    if ext == ".exr":
        write_exr(path, rgb)
        return
    if ext == ".pfm":
        _write_pfm(path, rgb)
        return
    if ext != ".png":
        raise NotImplementedError(f"pbrt_tpu_torch does not write '{ext}' images (PIL-only in the reference)")
    ldr = (linear_to_srgb(rgb) * 255.0 + 0.5).astype(np.uint8)
    write_png(path, ldr)


# ---------------------------------------------------------------------------
# PNG (non-interlaced, 8-bit samples or sub-byte gray and palette): the
# subset of what PIL gives the reference that imagemaps and LDR film use
# ---------------------------------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path, img):
    """Write (H, W, C) or (H, W) uint8 as PNG: C = 1 gray, 2 gray + alpha,
    3 RGB, 4 RGBA; every row uses filter 0 (none)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: 0 none, 1 sub, 2 up, 3 average, 4 Paeth."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        cur = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            line = cur
        elif ftype == 1:
            line = np.cumsum(cur.reshape(-1, bpp), axis=0).ravel() & 0xFF
        elif ftype == 2:
            line = (cur + prev) & 0xFF
        elif ftype in (3, 4):
            ln, up = cur.tolist(), prev.tolist()
            for x in range(stride):
                a = ln[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) >> 1
                else:
                    b = up[x]
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                ln[x] = (ln[x] + pred) & 0xFF
            line = np.asarray(ln, np.int64)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = line
    return out


def read_png(path):
    """Read a non-interlaced PNG of 8-bit samples (or 1, 2, 4-bit gray and
    palette indices) -> (H, W, 3) uint8 RGB: gray is replicated, alpha
    dropped and palettes expanded, as PIL's ``convert("RGB")`` does."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_PNG_MAGIC):
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    palette = None
    hdr = None
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4: pos + 8]
        data = buf[pos + 8: pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    sub_byte = depth in (1, 2, 4) and ctype in (0, 3)
    if interlace != 0 or ctype not in _PNG_CHANNELS or not (depth == 8 or sub_byte):
        raise NotImplementedError(f"{path}: only non-interlaced 8-bit PNG, or 1-, 2- and 4-bit gray and "
                                  f"palette PNG, is supported (bit depth {depth}, color type {ctype}, "
                                  f"interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = (w * c * depth + 7) // 8
    rows = _png_unfilter(data, h, stride, max(c * depth // 8, 1))
    if sub_byte:
        bits = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(h, w, depth)
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)[..., None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        px = rows.reshape(h, w, c)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[px[..., 0]]
    if c <= 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _read_pfm(path):
    with open(path, "rb") as f:
        kind = f.readline().strip()
        dims = f.readline().split()
        scale = float(f.readline())
        w, h = int(dims[0]), int(dims[1])
        count = w * h * (3 if kind == b"PF" else 1)
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dt).astype(np.float32)
    img = data.reshape(h, w, -1)[::-1]  # PFM is bottom-up
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img * abs(scale))


def _write_pfm(path, rgb):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(rgb[::-1], dtype="<f4").tobytes())
