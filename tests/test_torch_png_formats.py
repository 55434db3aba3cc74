"""The port's PNG reader (`data/png.py`) against the JAX package's readers:
``load_grayscale`` (``cv2.imread(..., IMREAD_GRAYSCALE)``, then PIL's
``convert("L")``) for `png.decode_gray`, and PIL's ``np.asarray(Image.open
(path))`` (the DDSM reader's fallback) for `png.decode_native`, on every
colour type and bit depth, Adam7 interlacing, the ``gAMA`` / ``sRGB`` /
``cHRM`` / ``tRNS`` / ``sBIT`` chunks, files cv2's and PIL's writers make,
cut and corrupt files (where cv2 refuses and PIL reads, PIL's image);
DDSM's ``read_pixels`` and ``load_view`` on pre-converted PNGs of every
mode; the native Adam7 and sub-byte code against their numpy twins."""

import re
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, PngImagePlugin

from torch_codecs import encode_png_any
from torch_datasets_tree import mammogram
from torch_mura_tree import xray_like
from xfmamba_tpu.data import ddsm as jax_ddsm
from xfmamba_tpu.data import transforms as jax_transforms
from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data import ddsm, png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(c, d) for c, ds in DEPTHS.items() for d in ds]


def image_of(rng, colour, depth, h=13, w=21):
    """(samples, palette) of a random image, with a run of equal channels
    (libpng's gray shortcut) and a smooth part."""
    ch = CHANNELS[colour]
    top = (1 << depth) - 1
    px = rng.integers(0, top + 1, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    px[0, :4] = px[0, 0]
    if h > 1:
        px[1] = (np.linspace(0, top, w)[:, None] * np.ones(ch)).astype(px.dtype)
    pal = rng.integers(0, 256, ((1 << depth) if colour == 3 else 0, 3)).astype(np.uint8)
    return (px[:, :, 0] if ch == 1 else px), (pal if colour == 3 else None)


def check(tmp_path, raw, name="x.png"):
    """`png.load_grayscale` against the JAX package's ``load_grayscale`` and
    `png.decode_native` against PIL's ``np.asarray(Image.open(...))``: the
    same arrays, or a ValueError naming the file where they raise."""
    path = tmp_path / name
    path.write_bytes(raw)
    try:
        want = jax_transforms.load_grayscale(str(path))
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError) as e:
            png.load_grayscale(str(path))
        assert str(path) in str(e.value)
    else:
        got = png.load_grayscale(str(path))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(png.load_grayscale(str(path), native.png_unfilter_plain),
                                      want, err_msg=name)
    try:
        nat = np.asarray(Image.open(path))
    except Exception:
        nat = None
    if nat is None:
        with pytest.raises(ValueError):
            png.decode_native(raw, str(path))
    else:
        got = png.decode_native(raw, str(path))
        assert got.dtype == nat.dtype and got.shape == nat.shape, name
        np.testing.assert_array_equal(got, nat, err_msg=name)
    return want


@pytest.mark.parametrize("colour,depth", KINDS)
@pytest.mark.parametrize("interlace", [False, True])
def test_every_kind(tmp_path, colour, depth, interlace):
    """Every colour type at every bit depth, plain and Adam7-interlaced,
    each filter type, sizes from 1 x 1 (empty passes) up."""
    rng = np.random.default_rng(10 * colour + depth + interlace)
    for h, w in ((1, 1), (3, 2), (13, 21), (9, 8)):
        for filters in ((0, 1, 2, 3, 4), (4,), (3, 1)):
            px, pal = image_of(rng, colour, depth, h, w)
            check(tmp_path, encode_png_any(px, colour, depth, palette=pal, interlace=interlace,
                                           filters=filters))


CHUNKS = {
    "gAMA 0.45455": [(b"gAMA", struct.pack(">I", 45455))],
    "gAMA 0.7": [(b"gAMA", struct.pack(">I", 70000))],
    "gAMA 2.2": [(b"gAMA", struct.pack(">I", 220000))],
    "gAMA 1.02 (insignificant)": [(b"gAMA", struct.pack(">I", 102000))],
    "sRGB": [(b"sRGB", b"\x00")],
    "sRGB over gAMA": [(b"gAMA", struct.pack(">I", 100000)), (b"sRGB", b"\x01")],
    "cHRM": [(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000,
                                   6000))],
    "sBIT 10 with gAMA": [(b"gAMA", struct.pack(">I", 45455)), (b"sBIT", b"\x0a\x0a\x0a")],
    "gAMA bad CRC": "bad-crc",
}


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("colour,depth", [(2, 8), (2, 16), (3, 8), (3, 4), (6, 16), (0, 8)])
def test_ancillary_chunks(tmp_path, chunk, colour, depth):
    """gAMA and sRGB make libpng's rgb_to_gray work in linear light (at 8
    and 16 bits); cHRM does not (cv2 sets the weights); an sBIT chunk moves
    the 16-bit tables' shift; a gAMA chunk with a bad CRC is ignored."""
    rng = np.random.default_rng(len(chunk) + depth)
    px, pal = image_of(rng, colour, depth)
    chunks = CHUNKS[chunk]
    if chunk == "gAMA bad CRC":
        raw = encode_png_any(px, colour, depth, palette=pal,
                             chunks=[(b"gAMA", struct.pack(">I", 45455))])
        i = raw.index(b"gAMA") + 8
        raw = raw[:i] + bytes([raw[i] ^ 1]) + raw[i + 1:]
    else:
        if colour == 0:
            chunks = [c for c in chunks if c[0] != b"sBIT"]
        if colour == 3:
            chunks = [c for c in chunks if c[0] != b"sBIT"]
        raw = encode_png_any(px, colour, depth, palette=pal, chunks=chunks)
    check(tmp_path, raw)


@pytest.mark.parametrize("colour,depth", [(0, 1), (0, 2), (0, 16), (2, 8), (2, 16), (3, 2),
                                          (3, 8)])
def test_trns(tmp_path, colour, depth):
    """A tRNS chunk changes neither cv2's gray nor PIL's array."""
    px, pal = image_of(np.random.default_rng(depth), colour, depth)
    body = {0: struct.pack(">H", 1), 2: struct.pack(">3H", 1, 2, 3), 3: bytes([0, 128])}[colour]
    check(tmp_path, encode_png_any(px, colour, depth, palette=pal, chunks=[(b"tRNS", body)]))


def test_cv2_and_pil_writers(tmp_path):
    """Files from cv2 (gray, 16-bit gray and colour) and PIL (1-bit, 4-bit
    palette, palette with transparency, LA, I;16, RGBA, and a gAMA chunk
    through PngInfo)."""
    rng = np.random.default_rng(3)
    g = xray_like(rng, 37, 29)
    rgb = np.stack([g, np.roll(g, 3, 1), 255 - g], 2)
    writers = {
        "cv2 gray": lambda p: cv2.imwrite(p, g),
        "cv2 gray16": lambda p: cv2.imwrite(p, g.astype(np.uint16) * 257 + 1),
        "cv2 bgr16": lambda p: cv2.imwrite(p, rgb.astype(np.uint16) * 251),
        "cv2 bgra": lambda p: cv2.imwrite(p, np.concatenate([rgb, g[:, :, None]], 2)),
        "pil 1": lambda p: Image.fromarray(g > 100).save(p),
        "pil P bits 4": lambda p: Image.fromarray(rgb).quantize(16).save(p, bits=4),
        "pil P transparency": lambda p: Image.fromarray(rgb).quantize(64).save(p, transparency=3),
        "pil LA": lambda p: Image.fromarray(rgb).convert("LA").save(p),
        "pil I;16": lambda p: Image.fromarray(g.astype(np.uint16) * 200).save(p),
        "pil RGBA": lambda p: Image.fromarray(rgb).convert("RGBA").save(p),
    }
    info = PngImagePlugin.PngInfo()
    info.add(b"gAMA", struct.pack(">I", 45455))
    writers["pil RGB gAMA"] = lambda p: Image.fromarray(rgb).save(p, pnginfo=info)
    for name, write in writers.items():
        path = str(tmp_path / "w.png")
        write(path)
        with open(path, "rb") as f:
            check(tmp_path, f.read(), f"{name}.png")


@pytest.mark.parametrize("colour,depth,interlace", [(0, 8, False), (2, 8, True), (3, 4, False),
                                                    (0, 2, True), (2, 16, False),
                                                    (6, 8, False)])
def test_cut_and_corrupt_files(tmp_path, colour, depth, interlace):
    """Seeded cut points and single-byte changes: cv2 refuses a bad CRC in
    IDAT, a short or unchecked image stream, no IEND; PIL then reads every
    file whose rows are all there (the port returns PIL's gray); both refuse
    the rest."""
    px, pal = image_of(np.random.default_rng(depth + colour), colour, depth)
    raw = encode_png_any(px, colour, depth, palette=pal, interlace=interlace,
                         chunks=[(b"gAMA", struct.pack(">I", 45455))] if colour == 2 else [])
    rng = np.random.default_rng(len(raw))
    for cut in sorted(set(rng.integers(8, len(raw), 12).tolist() + list(range(len(raw) - 16,
                                                                             len(raw))))):
        check(tmp_path, raw[:cut], f"cut{cut}.png")
    for t in range(24):
        b = bytearray(raw)
        b[int(rng.integers(8, len(raw)))] = int(rng.integers(0, 256))
        check(tmp_path, bytes(b), f"t{t}.png")


def test_native_adam7_and_unpack_match_twins():
    """The C++ Adam7 de-interlacer and sub-byte unpacker against their numpy
    twins on random filtered streams of every pixel size; a short stream
    and a filter type past 4 raise in both."""
    rng = np.random.default_rng(5)
    for bits in (1, 2, 4, 8, 16, 24, 32, 48, 64):
        for h, w in ((1, 1), (5, 3), (17, 11), (8, 16)):
            size = native.adam7_size(w, h, bits)
            data = rng.integers(0, 256, size, dtype=np.uint8)
            pos = 0
            for _, _, ph, rb in native.adam7_passes(w, h, bits):
                data[pos:pos + ph * (rb + 1):rb + 1] = rng.integers(0, 5, ph)
                pos += ph * (rb + 1)
            got = native.png_adam7(data, w, h, bits)
            np.testing.assert_array_equal(got, native.png_adam7_plain(data, w, h, bits))
            for fn in (native.png_adam7, native.png_adam7_plain):
                with pytest.raises(ValueError, match="holds"):
                    fn(data[:-1], w, h, bits)
            data[0] = 9
            for fn in (native.png_adam7, native.png_adam7_plain):
                with pytest.raises(ValueError, match="interlaced row 0 has a filter type"):
                    fn(data, w, h, bits)
            if bits < 8:
                rows = rng.integers(0, 256, (h, -(-w * bits // 8)), dtype=np.uint8)
                for scale in (False, True):
                    np.testing.assert_array_equal(
                        native.png_unpack(rows, w, bits, scale),
                        native.png_unpack_plain(rows, w, bits, scale))


@pytest.mark.parametrize("colour,depth", KINDS)
def test_ddsm_pixels_and_view(tmp_path, colour, depth):
    """DDSM's pre-converted PNG of every mode: the port's ``read_pixels``
    equals JAX's PIL fallback (dtype float32, PIL's shape), and
    ``load_view`` (rescaled, overlaid) returns or raises as JAX's does."""
    rng = np.random.default_rng(depth)
    img16, mask = mammogram(rng, 48, 36, "LEFT")
    top = (1 << depth) - 1
    px = (img16.astype(np.int64) * top // 65535).astype(np.uint16 if depth == 16 else np.uint8)
    px = px if CHANNELS[colour] == 1 else np.stack([px] * CHANNELS[colour], 2)
    pal = np.stack([np.linspace(0, 255, 1 << depth)] * 3, 1).astype(np.uint8) \
        if colour == 3 else None
    base = tmp_path / "1-1"
    (tmp_path / "1-1.png").write_bytes(encode_png_any(px, colour, depth, palette=pal))
    (tmp_path / "1-2.png").write_bytes(encode_png_any(mask, 0, 8))
    want = jax_ddsm.read_pixels(str(base) + ".dcm")
    got = ddsm.read_pixels(str(base) + ".dcm")
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    view = dict(image_file=str(base) + ".dcm", mask_files=[str(tmp_path / "1-2.dcm")])
    for rescale, overlay in ((None, False), (0.5, True)):
        try:
            jax_out = jax_ddsm.load_view(view, "left", rescale_factor=rescale, overlay_mask=overlay)
        except ValueError:
            with pytest.raises(ValueError):
                ddsm.load_view(view, "left", rescale_factor=rescale, overlay_mask=overlay)
            continue
        out = ddsm.load_view(view, "left", rescale_factor=rescale, overlay_mask=overlay)
        for a, b in zip(out, jax_out):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _refused():
    """(file, the message's phrase) of what cv2 and PIL both refuse."""
    rng = np.random.default_rng(7)
    px, pal = image_of(rng, 3, 8)
    raw = encode_png_any(px, 3, 8, palette=pal)
    gray = encode_png_any(image_of(rng, 0, 8)[0], 0, 8)

    def spoil(data, kind, offset=0):
        i = data.index(kind) + 4 + offset
        return data[:i] + bytes([data[i] ^ 0x5A]) + data[i + 1:]

    idat = gray.index(b"IDAT")
    n = struct.unpack(">I", gray[idat - 4:idat])[0]
    body = zlib.decompress(gray[idat + 4:idat + 4 + n])
    bad_filter = zlib.compress(bytes([5]) + body[1:])
    chunk = struct.pack(">I", len(bad_filter)) + b"IDAT" + bad_filter + \
        struct.pack(">I", zlib.crc32(b"IDAT" + bad_filter))
    ihdr = gray.index(b"IHDR") + 4
    bad_depth = gray[:ihdr + 8] + b"\x03" + gray[ihdr + 9:ihdr + 13]
    bad_depth += struct.pack(">I", zlib.crc32(b"IHDR" + bad_depth[ihdr:])) + gray[ihdr + 17:]
    return [
        (b"GIF89a" + gray[6:], "not a PNG"),
        (spoil(gray, b"IHDR", 2), "bad IHDR chunk"),
        (bad_depth, "bad IHDR chunk"),
        (spoil(raw, b"PLTE", 1), "bad CRC in chunk b'PLTE'"),
        (gray[:idat + 4 + n // 2], "truncated"),
        (spoil(gray, b"IDAT", 6), "corrupt PNG image data"),
        (gray[:idat - 4] + chunk + gray[idat + 8 + n:], "filter type 5"),
    ]


def test_refused_formats_match_the_oracle(tmp_path):
    """Each kind of file cv2 and PIL both refuse raises a ValueError naming
    the file and the fault, and the module docstring's refusal list names
    it."""
    doc = " ".join(png.__doc__.split())
    for k, (raw, phrase) in enumerate(_refused()):
        path = tmp_path / f"r{k}.png"
        path.write_bytes(raw)
        with pytest.raises(Exception):
            jax_transforms.load_grayscale(str(path))
        with pytest.raises(ValueError, match=re.escape(phrase)) as e:
            png.load_grayscale(str(path))
        assert str(path) in str(e.value)
    for phrase in ("not a PNG", "a bad IHDR chunk", "a bad CRC in IHDR or PLTE",
                   "image data that is cut short or corrupt", "a filter type past 4"):
        assert phrase in doc, phrase


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_without_plte(tmp_path, depth):
    """A palette image with no PLTE chunk: cv2 refuses it, PIL reads its
    indices (and every pixel black through its empty palette); the port
    gives PIL's arrays."""
    px, pal = image_of(np.random.default_rng(depth), 3, depth)
    raw = encode_png_any(px, 3, depth, palette=pal)
    i = raw.index(b"PLTE") - 4
    raw = raw[:i] + raw[i + 12 + len(pal) * 3:]
    assert check(tmp_path, raw) is not None
