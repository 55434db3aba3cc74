"""The port's BMP, Netpbm (PBM / PGM / PPM, PAM, PFM) and Sun raster
readers (`data/bmp.py`, `data/pnm.py`, `data/sunras.py`, the run-length
loops of `native/raster_decode.cc`) against the JAX package's
``load_grayscale`` (``cv2.imread(..., IMREAD_GRAYSCALE)``, then PIL's
``convert("L")``), bit for bit, over seeded sweeps of each format's
variants with cut and corrupt files; the dispatch by content and its
refusal naming the formats the port does not read yet; phase 19's corpus
pinned to the oracle's digests; the re-encodings its training tree uses."""

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_codecs import (RASTER, RASTER_SHA256, bmp_rows, gray_digest, jpeg_frame, raster_file,
                          reencode_raster, rle_bmp, sunras_rle, sunras_rows, timing_file,
                          write_bmp, write_jpeg, write_pam, write_pfm, write_pnm, write_sunras,
                          write_tiff)
from torch_mura_tree import xray_like
from xfmamba_tpu.data import transforms as jax_transforms
from xfmamba_tpu_torch.data import bmp, image, pnm, sunras
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def oracle(path):
    try:
        return jax_transforms.load_grayscale(str(path))
    except Exception:
        return None


def parity(tmp_path, raw, name):
    """The port's gray image equals the oracle's, or both refuse (the port
    with a ValueError naming the file); returns the oracle's."""
    path = tmp_path / name
    path.write_bytes(raw)
    want = oracle(path)
    if want is None:
        with pytest.raises(ValueError) as e:
            image.load_grayscale(path)
        assert str(path) in str(e.value)
    else:
        got = image.load_grayscale(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return want


def damage(rng, raw: bytes, start: int) -> bytes:
    """``raw`` as it is, cut, or with a byte changed after ``start``."""
    r = rng.random()
    if r < .15 and len(raw) > start + 1:
        return raw[:int(rng.integers(start, len(raw)))]
    if r < .3 and len(raw) > start + 1:
        b = bytearray(raw)
        b[int(rng.integers(start, len(raw)))] = int(rng.integers(0, 256))
        return bytes(b)
    return raw


def bmp_case(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    header = int(rng.choice([12, 40, 40, 52, 56, 64, 108, 124]))
    bits = int(rng.choice([1, 4, 8, 16, 24, 32] if header != 12 else [1, 4, 8, 24, 32]))
    comp = 0
    if header != 12:
        if bits == 4 and rng.random() < .5:
            comp = 2
        elif bits == 8 and rng.random() < .5:
            comp = 1
        elif bits in (16, 24, 32) and rng.random() < .4:
            comp = 3
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
    top = header != 12 and rng.random() < .2
    pal, masks, used = None, None, 0
    if bits <= 8:
        used = int(rng.integers(1, 257)) if bits == 8 and rng.random() < .3 else 0
        n = used or 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        if rng.random() < .1:
            pal = np.repeat(np.arange(n)[:, None], 3, 1) if bits != 1 else \
                np.array([[0] * 3, [255] * 3])
        idx = rng.integers(0, n, (h, w))
        if rng.random() < .5:
            idx = np.repeat(idx[:, ::4], 4, axis=1)[:, :w]
        data = rle_bmp(idx, comp == 2, rng=rng, eob=rng.random() < .8, deltas=rng.random() < .3) \
            if comp else bmp_rows(idx, bits)
    elif bits == 16:
        if comp == 3:
            masks = [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0xF00, 0xF0, 0xF)][
                int(rng.integers(0, 3))]
        data = bmp_rows(rng.integers(0, 65536, (h, w)), 16)
    else:
        if comp == 3:
            masks = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                     (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xF00, 0xF0, 0xF, 0),
                     (0x3F << 20, 0x7 << 8, 0x1F, 0)][int(rng.integers(0, 5))]
        data = bmp_rows(rng.integers(0, 256, (h, w, bits // 8)), bits)
    raw = write_bmp(data, w, h, bits, comp, header, pal, masks, top, used)
    return damage(rng, raw, len(raw) - len(data))


@pytest.mark.parametrize("seed", range(80))
def test_bmp_matches_the_oracle(tmp_path, seed):
    parity(tmp_path, bmp_case(seed), f"b{seed}.bmp")


def pnm_case(seed: int) -> bytes:
    rng = np.random.default_rng(100 + seed)
    kind = int(rng.choice([1, 2, 3, 4, 5, 6]))
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    maxval = 1 if kind in (1, 4) else int(rng.choice([1, 50, 255, 255, 256, 1000, 65535]))
    ch = 3 if kind in (3, 6) else 1
    v = rng.integers(0, maxval + 1, (h, w, ch) if ch == 3 else (h, w))
    if kind in (2, 3) and rng.random() < .1:
        v = v + rng.integers(0, 3, v.shape)
    sep = [b" ", b"\n", b"  \t", b""][int(rng.integers(0, 4 if kind == 1 else 3))]
    raw = write_pnm(v, kind, maxval, comments=["c1", "", "c3"] if rng.random() < .3 else (),
                    sep=sep, line=int(rng.integers(0, 8)))
    return damage(rng, raw, 2)


@pytest.mark.parametrize("seed", range(60))
def test_pbm_pgm_ppm_match_the_oracle(tmp_path, seed):
    parity(tmp_path, pnm_case(seed), f"p{seed}.pnm")


# widths at which cv2's basic_conversion writes every pixel of a
# GRAYSCALE_ALPHA / RGB_ALPHA row and at most a few bytes past it (its
# out-of-bounds write grows with the width: wide files crash the oracle)
ALPHA_WIDTHS = {"GRAYSCALE_ALPHA": (1, 2, 3), "RGB_ALPHA": (1, 2, 3, 5, 6, 9)}


def pam_case(seed: int) -> bytes:
    rng = np.random.default_rng(200 + seed)
    depth = int(rng.integers(1, 5))
    maxval = int(rng.choice([1, 255, 255, 1000, 65535]))
    tupl = rng.choice([None, "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA",
                       "BLACKANDWHITE"])
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    if tupl in ALPHA_WIDTHS and depth == {"GRAYSCALE_ALPHA": 2, "RGB_ALPHA": 4}[tupl]:
        w = int(rng.choice(ALPHA_WIDTHS[tupl]))
    raw = write_pam(rng.integers(0, maxval + 1, (h, w, depth)), maxval, tupl,
                    comment=rng.random() < .3)
    return damage(rng, raw, 2)


@pytest.mark.parametrize("seed", range(40))
def test_pam_matches_the_oracle(tmp_path, seed):
    parity(tmp_path, pam_case(seed), f"a{seed}.pam")


@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5, -3.3, 2.0, -0.1])
def test_pfm_matches_the_oracle(tmp_path, scale):
    """Gray PFM in either byte order (rounded half to even, clamped, NaN
    and infinities to 0), colour PFM (both refuse), cut files."""
    rng = np.random.default_rng(int(abs(scale) * 10))
    vals = rng.normal(100, 120, (7, 11)).astype(np.float32)
    vals[0, :3] = (np.nan, np.inf, -np.inf)
    vals[1, :4] = (0.5, 1.5, 2.5, 254.5)
    parity(tmp_path, write_pfm(vals, scale), f"f{scale}.pfm")
    parity(tmp_path, write_pfm(np.stack([vals] * 3, 2), scale, colour=True), f"c{scale}.pfm")
    raw = write_pfm(vals, scale)
    parity(tmp_path, raw[:len(raw) - 9], f"cut{scale}.pfm")


def sun_case(seed: int) -> bytes:
    rng = np.random.default_rng(300 + seed)
    depth = int(rng.choice([1, 4, 8, 8, 24, 32]))
    kind = int(rng.choice([0, 1, 1, 2, 2, 3, 4, 5]))
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    cmap = rng.integers(0, 256, (3, int(rng.integers(1, (1 << depth) + 1)))) \
        if depth <= 8 and rng.random() < .5 else None
    if depth <= 8:
        v = rng.integers(0, 1 << depth, (h, w))
        if rng.random() < .5:
            v = np.repeat(v[:, ::5], 5, axis=1)[:, :w]
        if depth == 8 and rng.random() < .3:
            v[v % 7 == 0] = 0x80
    else:
        v = rng.integers(0, 256, (h, w, depth // 8))
        if rng.random() < .5:
            v = np.repeat(v[:, ::4], 4, axis=1)[:, :w]
    data = sunras_rows(v, depth, pad=kind != 2 or rng.random() < .3)
    if kind == 2:
        data = sunras_rle(data, runs=rng.random() < .8)
    raw = write_sunras(data, w, h, depth, kind, cmap)
    return damage(rng, raw, 32)


@pytest.mark.parametrize("seed", range(40))
def test_sun_raster_matches_the_oracle(tmp_path, seed):
    parity(tmp_path, sun_case(seed), f"s{seed}.ras")


CV2_WRITES = [(".bmp", "gray", []), (".bmp", "colour", []), (".pgm", "gray", []),
              (".pgm", "gray16", []), (".pgm", "gray", [cv2.IMWRITE_PXM_BINARY, 0]),
              (".ppm", "colour", []), (".pbm", "gray", []),
              (".pam", "colour", [cv2.IMWRITE_PAM_TUPLETYPE, cv2.IMWRITE_PAM_FORMAT_RGB]),
              (".pam", "gray", []), (".pfm", "float", []), (".ras", "gray", []),
              (".ras", "colour", [])]


@pytest.mark.parametrize("ext, kind, params", CV2_WRITES)
def test_files_cv2_writes(tmp_path, ext, kind, params):
    rng = np.random.default_rng(len(ext) + len(kind))
    g = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    arr = {"gray": g, "colour": rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
           "gray16": g.astype(np.uint16) * 257 + 3, "float": g.astype(np.float32) / 255}[kind]
    path = tmp_path / f"cv{ext}"
    assert cv2.imwrite(str(path), arr, params)
    assert parity(tmp_path, path.read_bytes(), f"cv{kind}{ext}") is not None


@pytest.mark.parametrize("mode, ext", [("L", ".pgm"), ("RGB", ".ppm"), ("1", ".pbm"),
                                       ("L", ".bmp"), ("RGB", ".bmp"), ("P", ".bmp"),
                                       ("1", ".bmp")])
def test_files_pil_writes(tmp_path, mode, ext):
    rng = np.random.default_rng(len(mode) + len(ext))
    arr = rng.integers(0, 256, (13, 17, 3) if mode == "RGB" else (13, 17), dtype=np.uint8)
    path = tmp_path / f"pil{ext}"
    Image.fromarray(arr).convert(mode).save(path)
    assert parity(tmp_path, path.read_bytes(), f"pil{mode}{ext}") is not None


WIDE = (1 << 20) + 1
SIZE_CASES = {
    "P5 past 2^20 wide": write_pnm(np.zeros((1, WIDE), np.uint8), 5),
    "P5 2^20 wide": write_pnm(np.full((1, 1 << 20), 7, np.uint8), 5),
    "P2 past 2^20 tall": write_pnm(np.ones((WIDE, 1), np.int64), 2, 50),
    "P5 2^30 pixels, cut": b"P5\n1048576 1024\n255\n" + bytes(100),
    "P5 past 2^30 pixels": b"P5\n1048576 1025\n255\n" + bytes(100),
    "PFM 0 x 0": b"Pf\n0 0\n-1.0\n",
    "BMP 100000 x 100000": write_bmp(bytes(100), 100000, 100000, 24),
    "TIFF 100000 x 100000": write_tiff(np.zeros((2, 2), np.uint8),
                                       tags={256: (4, [100000]), 257: (4, [100000])}),
    "TIFF float 100000 x 100000": write_tiff(np.zeros((2, 2), np.float32), bits=32, kind="f",
                                             tags={256: (4, [100000]), 257: (4, [100000])}),
    "TIFF 2-bit past 2^20 wide": write_tiff(np.zeros((1, WIDE), np.uint8), bits=2),
    "Sun 100000 x 100000": write_sunras(bytes(100), 100000, 100000, 8, 1),
    "JPEG 40000 x 40000": (lambda raw: raw[:raw.index(b"\xff\xc0") + 5] + bytes.fromhex("9c409c40")
                           + raw[raw.index(b"\xff\xc0") + 9:])(
        write_jpeg(*jpeg_frame([np.zeros((8, 8), np.uint8)], [(1, 1)]), [((0,), 0, 63, 0, 0)])),
}


@pytest.mark.parametrize("name", list(SIZE_CASES))
def test_size_limits(tmp_path, name):
    """Past cv2's limits (2^20 a side, 2^30 pixels) the JAX reader raises
    once cv2 has read the header, and so does the port; where cv2's header
    reader refuses first, PIL reads what its bomb limit allows."""
    parity(tmp_path, SIZE_CASES[name], name.replace(" ", "_"))


def test_reported_probes(tmp_path):
    """A PGM with maxval 50 keeps 0-50 (raw) or is scaled (ASCII); 16-bit
    samples by their high byte; an 8-bit BMP's end of line, delta and end
    of bitmap fill with palette entry 0; a Sun raster without a colour map
    reads as black."""
    v = np.array([[0, 25, 49, 50]])
    assert parity(tmp_path, write_pnm(v, 5, 50), "m50.pgm").tolist() == [[0, 25, 49, 50]]
    assert parity(tmp_path, write_pnm(v, 2, 50), "m50a.pgm").tolist() == [[0, 127, 249, 255]]
    assert parity(tmp_path, write_pnm(np.array([[383, 32767]]), 5, 65535),
                  "w16.pgm").tolist() == [[1, 127]]
    pal = np.array([[10, 20, 30]] + [[200, 100, 50]] * 255)
    rle = bytes([2, 1, 0, 0, 0, 2, 1, 0, 1, 1, 0, 1])
    got = parity(tmp_path, write_bmp(rle, 4, 2, 8, 1, palette=pal), "rle.bmp")
    entry0 = (10 * 4899 + 20 * 9617 + 30 * 1868 + 8192) >> 14
    entry1 = (200 * 4899 + 100 * 9617 + 50 * 1868 + 8192) >> 14
    assert got.tolist() == [[entry0, entry1, entry0, entry0], [entry1, entry1, entry0, entry0]]
    g = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert not parity(tmp_path, write_sunras(sunras_rows(g, 8), 4, 3, 8, 1), "k.ras").any()


def test_corpus_digests_pinned_to_the_oracle(tmp_path):
    """Phase 19's files at 390 x 320: the oracle gives `RASTER_SHA256`, and
    the port gives the oracle's images."""
    assert set(RASTER) == set(RASTER_SHA256)
    for name in RASTER:
        want = parity(tmp_path, raster_file(name), name)
        assert want is not None and gray_digest(want) == RASTER_SHA256[name], name


@pytest.mark.parametrize("kind", ["tiff16", "pgm", "bmp8"])
def test_training_tree_reencodings(tmp_path, kind):
    """Phase 19's MURA tree views read back as the gray images written."""
    g = xray_like(np.random.default_rng(4), 37, 29)
    np.testing.assert_array_equal(parity(tmp_path, reencode_raster(g, kind), kind), g)


@pytest.mark.parametrize("kind", ["tiff", "pgm", "bmp", "png"])
def test_timing_files_decode_to_their_image(tmp_path, kind):
    raw, want = timing_file(kind, (45, 38))
    np.testing.assert_array_equal(parity(tmp_path, raw, f"t.{kind}"), want)


OTHER = {"GIF": b"GIF89a\x01\x00\x01\x00\x00\x00\x00;",
         "WebP": b"RIFF\x1a\x00\x00\x00WEBPVP8 " + bytes(14),
         "JPEG 2000": b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(20),
         "AVIF": b"\x00\x00\x00\x1cftypavif" + bytes(16),
         "HDR": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 1\n" + bytes(4),
         "ICO": b"\x00\x00\x01\x00\x01\x00" + bytes(16),
         "PCX": b"\x0a\x05\x01\x08" + bytes(124),
         "TGA": bytes([0, 0, 3]) + bytes(9) + b"\x02\x00\x02\x00\x08\x00" + bytes(4)}


@pytest.mark.parametrize("name", list(OTHER))
def test_other_formats_are_named(tmp_path, name):
    """A format cv2 or PIL reads and the port does not yet raises a
    ValueError that names it; unknown bytes raise as no format known."""
    path = tmp_path / "x.img"
    path.write_bytes(OTHER[name])
    with pytest.raises(ValueError, match=f"{name} image, a format the port does not read yet"):
        image.load_grayscale(path)
    assert image.other_format(b"\x01\x02\x03" * 10) is None


def test_docstrings_name_the_findings():
    for module, phrases in ((bmp, ("fill, not skip", "40-byte header keeps them",
                                   "float32 gray", "read twice")),
                            (pnm, ("maxval 50 keeps 0-50", "basic_conversion", "half to even",
                                   "one digit a pixel")),
                            (sunras, ("reads as black", "GIMP brush"))):
        doc = " ".join(module.__doc__.split())
        for phrase in phrases:
            assert phrase in doc, (module.__name__, phrase)
