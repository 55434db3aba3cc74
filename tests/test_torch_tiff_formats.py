"""The port's TIFF reader (`data/tiff.py`, `native/tiff_decode.cc`) against
the JAX package's ``load_grayscale`` (``cv2.imread(..., IMREAD_GRAYSCALE)``,
then PIL's ``convert("L")``), bit for bit: a seeded sweep of layouts
(photometrics, depths, sample formats, extra samples, contiguous and
planar, strips and tiles, both byte orders, BigTIFF, FillOrder 2,
orientations 1-8, several pages), every codec (none, LZW, Deflate,
PackBits with the predictors; CCITT RLE, Group 3 1D / 2D and Group 4 from
PIL's writer and from the numpy encoder; JPEG with JPEGTables from PIL's
writer and YCbCr 4:2:0 strips from the numpy JPEG encoder), files cv2
writes, cut and corrupt files, and the refusals.  Where the oracle raises,
the port raises a ``ValueError`` naming the file."""

import struct

import cv2
import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from torch_codecs import (RASTER, fax_encode, jpeg_frame, raster_file, write_jpeg, write_tiff,
                          ycbcr_blocks)
from xfmamba_tpu.data import transforms as jax_transforms
from xfmamba_tpu_torch.data import image, tiff
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 3}


def oracle(path):
    try:
        return jax_transforms.load_grayscale(str(path))
    except Exception:
        return None


def parity(tmp_path, raw, name="x.tif"):
    """The port's gray image of ``raw`` equals the oracle's, or both refuse
    (the port with a ValueError naming the file); returns the oracle's."""
    path = tmp_path / name
    path.write_bytes(raw)
    want = oracle(path)
    if want is None:
        with pytest.raises(ValueError) as e:
            image.load_grayscale(path)
        assert str(path) in str(e.value)
        assert "not yet read" not in str(e.value), str(e.value)
    else:
        got = image.load_grayscale(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return want


def layout_case(seed: int):
    """A random layout the port reads (the sweep's case ``seed``)."""
    rng = np.random.default_rng(seed)
    photo = int(rng.choice([0, 1, 1, 2, 3, 5, 6]))
    bits = int(rng.choice({0: [1, 2, 4, 8, 16], 1: [1, 2, 4, 8, 12, 16, 32], 2: [8, 16],
                           3: [1, 2, 4, 8], 5: [8, 16], 6: [8]}[photo]))
    spp = BASE[photo] + int(rng.integers(0, 2))
    if bits < 8 and photo in (0, 1, 3):
        spp = 1
    kind = "u" if rng.random() < .85 or bits < 8 or bits == 12 or spp > 1 else \
        ("f" if bits == 32 else "i")
    planar = 2 if spp > 1 and photo != 3 and rng.random() < .3 else 1
    comp = int(rng.choice([1, 5, 8, 32946, 32773])) if bits != 12 else 1
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    if rng.random() < .2:
        w = h
    tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3))) if rng.random() < .3 \
        else None
    orient = int(rng.choice([1, 2, 3, 4, 5, 6, 7, 8])) if rng.random() < .4 else None
    fill = 2 if rng.random() < .15 else 1
    extra = [int(rng.choice([0, 1, 2]))] if spp > BASE[photo] else None
    if photo == 6 and (orient or 1) >= 5:
        orient = None
    if kind == "f":
        px = (rng.random((h, w, spp)) * 300 - 20).astype(np.float32)
    else:
        px = rng.integers(0, 2 ** min(bits, 31), (h, w, spp)).astype(np.uint32)
        if rng.random() < .5:
            yy, xx = np.mgrid[:h, :w]
            px[..., 0] = (yy * 7 + xx * 3) % (2 ** min(bits, 31))
    cmap = rng.integers(0, 65536 if rng.random() < .5 else 256, (2 ** bits, 3)) \
        if photo == 3 else None
    pred = 1
    if comp in (5, 8, 32946) and bits in (8, 16, 32) and rng.random() < .5:
        pred = 3 if kind == "f" else 2
    return write_tiff(px, bits=bits, kind=kind, photometric=photo, compression=comp,
                      predictor=pred, order="<" if rng.random() < .5 else ">", planar=planar,
                      extra_samples=extra, colormap=cmap, rows_per_strip=int(rng.integers(1, h + 3)),
                      tile=tile, orientation=orient, fill_order=fill,
                      bigtiff=rng.random() < .2 and not orient, ifd_first=rng.random() < .5,
                      pages=2 if rng.random() < .1 else 1,
                      tags={530: (3, [1, 1])} if photo == 6 else None)


@pytest.mark.parametrize("seed", range(120))
def test_layouts_match_the_oracle(tmp_path, seed):
    parity(tmp_path, layout_case(seed), f"layout{seed}.tif")


def damaged_case(seed: int) -> bytes:
    """A file of the usual codecs cut or with bytes changed inside its strips."""
    rng = np.random.default_rng(1000 + seed)
    photo = int(rng.choice([0, 1, 1, 2, 3]))
    bits = int(rng.choice({0: [1, 8, 16], 1: [8, 16, 32], 2: [8, 16], 3: [4, 8]}[photo]))
    spp = BASE[photo]
    kind = "f" if bits == 32 and rng.random() < .5 else "u"
    comp = int(rng.choice([1, 5, 5, 8, 32773]))
    h, w = int(rng.integers(4, 48)), int(rng.integers(4, 48))
    yy, xx = np.mgrid[:h, :w]
    if kind == "f":
        px = ((yy * 5 + xx) % 300 - 20).astype(np.float32)[..., None] * np.ones(spp, np.float32)
    else:
        px = (((yy * 7 + xx * 3) * (2 ** bits // 97 + 1)) % (2 ** bits)).astype(np.uint32)
        px = px[..., None] * np.ones(spp, np.uint32)
    pred = 2 if comp in (5, 8) and bits in (8, 16) and rng.random() < .5 else 1
    if kind == "f" and comp in (5, 8) and rng.random() < .5:
        pred = 3
    raw = write_tiff(px, bits=bits, kind=kind, photometric=photo, compression=comp,
                     predictor=pred, order="<" if rng.random() < .5 else ">",
                     colormap=rng.integers(0, 256, (2 ** bits, 3)) if photo == 3 else None,
                     rows_per_strip=int(rng.integers(1, h + 1)),
                     tile=(16, 32) if rng.random() < .25 else None)
    start = min(tiff.Layout(tiff.Directory(raw)).offsets)
    if rng.random() < .5:
        return raw[:int(rng.integers(start, len(raw)))]
    b = bytearray(raw)
    for _ in range(int(rng.integers(1, 4))):
        b[int(rng.integers(start, len(raw)))] = int(rng.integers(0, 256))
    return bytes(b)


@pytest.mark.parametrize("seed", range(40))
def test_cut_and_corrupt_files_match_the_oracle(tmp_path, seed):
    parity(tmp_path, damaged_case(seed), f"damaged{seed}.tif")


def _pil_fax(tmp_path, img, comp, rows, two_d=False):
    path = tmp_path / "pil.tif"
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[278] = rows
    if two_d:
        info[292] = 1
    Image.fromarray(img).convert("1").save(path, compression=comp, tiffinfo=info)
    return path.read_bytes()


@pytest.mark.parametrize("comp", ["group3", "group3-2d", "group4", "tiff_ccitt"])
def test_ccitt_from_pil_match_the_oracle(tmp_path, comp):
    """PIL's (libtiff's) CCITT files, vertical modes included, at several
    strip heights and widths past one make-up code."""
    rng = np.random.default_rng(7)
    for k, (h, w) in enumerate(((23, 37), (9, 1900), (40, 64))):
        img = rng.random((h, w)) < 0.3
        if k == 2:
            yy, xx = np.mgrid[:h, :w]
            img = (xx // 5 + yy // 3) % 2 == 0
        raw = _pil_fax(tmp_path, img, comp.split("-")[0], int(rng.integers(1, h + 1)),
                       comp.endswith("2d"))
        assert parity(tmp_path, raw, f"{comp}{k}.tif") is not None


@pytest.mark.parametrize("codec", [2, 3, 4, "3-2d"])
def test_ccitt_from_the_numpy_encoder(tmp_path, codec):
    """The numpy encoder's RLE, Group 3 (1D, and 2D in horizontal mode)
    and Group 4 strips, min-is-white and min-is-black, FillOrder 2."""
    rng = np.random.default_rng(11)
    two_d = codec == "3-2d"
    c = 3 if two_d else codec
    for k in range(3):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 3000 if k == 0 else 80))
        img = (rng.random((h, w)) < 0.2).astype(np.uint8)
        rows = int(rng.integers(1, h + 1))
        it = iter([fax_encode(img[y:y + rows], c, two_d) for y in range(0, h, rows)])
        raw = write_tiff(img, bits=1, photometric=k % 2, compression=c, rows_per_strip=rows,
                         fill_order=2 if k == 2 else 1, codec=lambda d: next(it),
                         tags={292: (4, [1 if two_d else 0])} if c == 3 else None)
        assert parity(tmp_path, raw, f"fax{codec}{k}.tif") is not None


@pytest.mark.parametrize("comp", ["group4", "tiff_ccitt"])
def test_damaged_ccitt_strips_match_the_oracle(tmp_path, comp):
    """Group 4 and RLE strips with bytes changed (one strip a file)."""
    rng = np.random.default_rng(5)
    for k in range(6):
        h, w = int(rng.integers(2, 30)), int(rng.integers(2, 50))
        raw = bytearray(_pil_fax(tmp_path, rng.random((h, w)) < 0.3, comp, h))
        lay = tiff.Layout(tiff.Directory(bytes(raw)))
        start, count = lay.offsets[0], lay.counts[0]
        for _ in range(2):
            raw[int(rng.integers(start, start + count))] = int(rng.integers(0, 256))
        parity(tmp_path, bytes(raw), f"damaged-{comp}{k}.tif")


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_jpeg_from_pil_match_the_oracle(tmp_path, mode):
    """PIL's JPEG-compressed TIFFs (JPEGTables; RGB written as YCbCr 4:2:0),
    with orientations read by cv2 and by PIL."""
    rng = np.random.default_rng(3)
    for k, (h, w, orient) in enumerate(((40, 56, 1), (33, 70, 3), (48, 48, 6), (21, 34, 5))):
        yy, xx = np.mgrid[:h, :w]
        base = (yy * 3 + xx * 5) % 256
        arr = base if mode == "L" else np.stack([base, 255 - base, (base * 7) % 256], 2)
        arr = np.clip(arr + rng.integers(0, 40, arr.shape), 0, 255).astype(np.uint8)
        info = TiffImagePlugin.ImageFileDirectory_v2()
        info[278] = 16
        info[274] = orient
        path = tmp_path / "j.tif"
        Image.fromarray(arr, mode).save(path, compression="jpeg", quality=int(rng.integers(40, 95)),
                                        tiffinfo=info)
        assert parity(tmp_path, path.read_bytes(), f"jpeg-{mode}{k}.tif") is not None


@pytest.mark.parametrize("sub", [(1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (2, 4)])
def test_uncompressed_subsampled_ycbcr(tmp_path, sub):
    """Blocks of lumas with their Cb and Cr, partial blocks at the edges,
    strips whose read libtiff cuts to its rounded-down scanline size; 2 x 4
    blocks, which libtiff's RGBA code has no routine for, refused."""
    rng = np.random.default_rng(sub[0] * 10 + sub[1])
    for k in range(3):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        rows = sub[1] * int(rng.integers(1, 5))
        ycc = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        it = iter(ycbcr_blocks(ycc, sub[0], sub[1], rows))
        raw = write_tiff(ycc, photometric=6, rows_per_strip=rows, tags={530: (3, list(sub))},
                         codec=lambda d: next(it), orientation=1 + k)
        assert (parity(tmp_path, raw, f"ycc{sub}{k}.tif") is None) == (sub == (2, 4))


@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (64, 16)])
def test_fill_order_2_tiles(tmp_path, tile):
    """Uncompressed FillOrder 2 tiles: cv2 reads those a whole number of KiB
    long; PIL reads the others where it has the raw mode."""
    rng = np.random.default_rng(tile[0] + tile[1])
    for k, (bits, photo, spp) in enumerate(((8, 1, 1), (8, 2, 3), (1, 1, 1), (16, 1, 1))):
        px = rng.integers(0, 2 ** bits, (45, 37, spp)).astype(np.uint32)
        parity(tmp_path, write_tiff(px, bits=bits, photometric=photo, tile=tile, fill_order=2),
               f"fo2-{k}.tif")


def test_jpeg_ycbcr_from_the_numpy_encoder(tmp_path):
    """YCbCr 4:2:0 and 4:2:2 strips from the numpy JPEG encoder (each strip
    its own datastream with its tables), and a gray one in tiles."""
    rng = np.random.default_rng(9)
    h, w = 70, 45
    planes = [rng.integers(0, 256, (h, w)).astype(np.uint8) for _ in range(3)]
    for sub in ((2, 2), (2, 1)):
        strips = []
        for y in range(0, h, 32):
            fr, q = jpeg_frame([p[y:y + 32] for p in planes], [sub, (1, 1), (1, 1)])
            strips.append(write_jpeg(fr, q, [((0, 1, 2), 0, 63, 0, 0)]))
        it = iter(strips)
        raw = write_tiff(np.stack(planes, 2), photometric=6, compression=7, rows_per_strip=32,
                         tags={530: (3, list(sub))}, codec=lambda d: next(it))
        assert parity(tmp_path, raw, f"ycbcr{sub}.tif") is not None
    tiles = []
    for y in range(0, h, 32):
        for x in range(0, w, 32):
            t = np.zeros((32, 32), np.uint8)
            part = planes[0][y:y + 32, x:x + 32]
            t[:part.shape[0], :part.shape[1]] = part
            fr, q = jpeg_frame([t], [(1, 1)])
            tiles.append(write_jpeg(fr, q, [((0,), 0, 63, 0, 0)]))
    it = iter(tiles)
    raw = write_tiff(planes[0], compression=7, tile=(32, 32), codec=lambda d: next(it))
    assert parity(tmp_path, raw, "jpeg-tiles.tif") is not None


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_files_cv2_writes(tmp_path, compression):
    """cv2.imwrite's TIFFs: 8-bit gray and colour, 16-bit gray."""
    rng = np.random.default_rng(compression)
    for k, arr in enumerate((rng.integers(0, 256, (31, 47), dtype=np.uint8),
                             rng.integers(0, 256, (20, 33, 3), dtype=np.uint8),
                             rng.integers(0, 65536, (25, 19), dtype=np.uint16))):
        path = tmp_path / f"cv{k}.tif"
        assert cv2.imwrite(str(path), arr, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
        assert parity(tmp_path, path.read_bytes(), f"cv{compression}-{k}.tif") is not None


def test_the_reported_probes(tmp_path):
    """The behaviours probed for this reader: 16-bit samples by their high
    byte (383 -> 1, 32767 -> 127); float and 32-bit integer samples through
    PIL (clipped, truncated); orientation 6 of a square image read by cv2,
    of a tall one by PIL; a single-strip uncompressed image with
    orientation 5 scrambled as PIL maps it."""
    g16 = np.array([[383, 32767, 65535, 0]], np.uint16)
    assert parity(tmp_path, write_tiff(g16, bits=16), "hi.tif").tolist() == [[1, 127, 255, 0]]
    f = np.array([[-3.5, 0.7, 254.9, 300.0]], np.float32)
    assert parity(tmp_path, write_tiff(f, bits=32, kind="f"), "f.tif").tolist() == \
        [[0, 0, 254, 255]]
    i32 = np.array([[-7, 12, 256, 99999]])
    assert parity(tmp_path, write_tiff(i32, bits=32, kind="i"), "i.tif").tolist() == \
        [[0, 12, 255, 255]]
    g = np.arange(35, dtype=np.uint8).reshape(5, 7)
    sq = np.arange(36, dtype=np.uint8).reshape(6, 6)
    np.testing.assert_array_equal(parity(tmp_path, write_tiff(sq, orientation=6), "o6sq.tif"),
                                  np.rot90(sq, -1))
    np.testing.assert_array_equal(
        parity(tmp_path, write_tiff(g, orientation=6, rows_per_strip=2), "o6.tif"),
        np.rot90(g, -1))
    np.testing.assert_array_equal(parity(tmp_path, write_tiff(g, orientation=5), "o5.tif"),
                                  g.reshape(7, 5).T)


def test_refusals_and_variants_not_yet_read(tmp_path):
    """Files both readers refuse raise naming the file; a variant the port
    does not read yet raises saying so."""
    g = np.arange(48, dtype=np.uint8).reshape(6, 8)
    refused = {
        "float64": write_tiff(g.astype(np.float64), bits=64, kind="f"),
        "palette16": write_tiff(g, bits=16, photometric=3, colormap=np.zeros((65536, 3))),
        "no width": write_tiff(g, tags={256: (4, [])}),
        "cut header": write_tiff(g)[:6],
        "strip past the end": write_tiff(g, compression=5)[:-30],
    }
    for name, raw in refused.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(raw)
        assert oracle(path) is None, name
        with pytest.raises(ValueError, match="unreadable TIFF|not a PNG") as e:
            image.load_grayscale(path)
        assert str(path) in str(e.value)
    old_jpeg = write_tiff(g, compression=6)
    with pytest.raises(ValueError, match="not yet read by the port: old-style JPEG"):
        tiff.decode_gray(old_jpeg, "old.tif")


def _fault_cases():
    g = np.arange(48, dtype=np.uint8).reshape(6, 8)
    big = bytearray(write_tiff(g, bigtiff=True))
    pos = bytes(big).find(struct.pack("<Q", tiff.Directory(bytes(big)).first(273)))
    big[pos:pos + 8] = struct.pack("<Q", (1 << 63) + 5)
    return {
        "huge tiles": write_tiff(g, tile=(16, 16), tags={322: (4, [1 << 20]), 323: (4, [1 << 20])}),
        "float SamplesPerPixel": write_tiff(g, tags={277: (11, [1.0])}),
        "float ImageWidth": write_tiff(g, tags={256: (11, [8.0])}),
        "BigTIFF offset past 2^63": bytes(big),
        "JPEG YCbCr with one sample": write_tiff(g, photometric=6, compression=7,
                                                 codec=lambda d: d),
        "2^30 one-row strips": write_tiff(g, tags={257: (4, [1 << 30]), 278: (4, [1])}),
    }


@pytest.mark.parametrize("name", list(_fault_cases()))
def test_directory_faults(tmp_path, name):
    """Directories that would make a naive reader allocate gigabytes or
    mistake a tag's type: held to the oracle, refused before allocating."""
    parity(tmp_path, _fault_cases()[name], name.replace(" ", "_") + ".tif")


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_headers_raise_value_errors(seed):
    """Bytes changed in the header and directories of the corpus files:
    every reader gives a uint8 image or a ValueError, nothing else."""
    rng = np.random.default_rng(500 + seed)
    for name in RASTER:
        raw = bytearray(raster_file(name, (40, 32)))
        for _ in range(int(rng.integers(1, 4))):
            raw[int(rng.integers(0, min(len(raw), 400)))] = int(rng.integers(0, 256))
        try:
            out = image.decode_grayscale(bytes(raw), name)
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim == 2, name


def test_native_decoder_statuses():
    """`native.tiff_decode_chunks` reports a strip past the end of the file
    (2), a codec failure with what it decoded kept and zeros after it (1),
    and applies no predictor to a failed strip."""
    from torch_codecs import lzw_encode
    from xfmamba_tpu_torch import native
    data = bytes(range(64)) * 2
    enc = lzw_encode(data)
    raw = enc + enc[:len(enc) // 2]
    buf, status = native.tiff_decode_chunks(raw, [0, len(enc), len(raw) - 4], [len(enc), len(enc) // 2, 99],
                                            [128, 128, 128], [0, 128, 256], 384, codec=5,
                                            predictor=2, row_bytes=128)
    assert status.tolist() == [0, 1, 2]
    diffed = np.frombuffer(data, np.uint8).cumsum(dtype=np.uint8)
    np.testing.assert_array_equal(buf[:128], diffed)
    half = buf[128:256]
    decoded = int(np.argmin(half == np.frombuffer(data, np.uint8)))
    assert 0 < decoded < 128 and not half[decoded:].any()
    assert not buf[256:].any()


def test_module_docstring_names_the_findings():
    doc = " ".join(tiff.__doc__.split())
    for phrase in ("TIFFReadRGBA", "v >> 8", "(v + 128) // 257", "planar min-is-white is not "
                   "inverted", "clipped tile's rows", "only a square image survives",
                   "OPEN_INFO", "memory-mapped", "old-style JPEG", "big-endian BigTIFF",
                   "Group 3 strip"):
        assert phrase in doc, phrase
