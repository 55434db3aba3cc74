"""The port's JPEG decoder (`data/jpeg.py` with `native/jpeg_decode.cc`)
against ``cv2.imread(..., IMREAD_GRAYSCALE)``, which the JAX package's
``load_grayscale`` calls, bit for bit: cv2-encoded files at qualities 30-100,
gray and YCbCr at 4:4:4 / 4:2:2 / 4:2:0, optimised Huffman tables, restart
intervals, odd sizes, EXIF orientations 1-8; the numpy encoder's files of
tests/torch_datasets_tree.py; the formats cv2 and PIL refuse; the loader's
sniffing by content (tests/test_torch_jpeg_formats.py has the formats
beyond baseline)."""

import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from torch_datasets_tree import encode_jpeg, exif_app1, with_segment
from torch_mura_tree import encode_png, xray_like
from xfmamba_tpu.data import transforms as jax_transforms
from xfmamba_tpu_torch.data import image, jpeg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = [(1, 1), (7, 9), (17, 33), (390, 320)]
SAMPLING = {"gray": None, "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _image(rng, h, w, colour):
    g = xray_like(rng, h, w) if h * w > 1 else np.array([[131]], np.uint8)
    if not colour:
        return g
    return np.stack([g, np.roll(g, 3, 1), 255 - g], 2)


def _cv2_jpeg(img, quality=90, sampling=None, optimize=0, restart=0, progressive=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_gray(raw):
    return cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [30, 50, 75, 90, 100])
def test_jpeg_matches_cv2(sampling, quality):
    """Every size, with and without optimised tables and a restart interval
    of 2 MCUs: the port's gray image equals cv2's bitwise."""
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        img = _image(rng, h, w, sampling != "gray")
        for optimize in (0, 1):
            for restart in (0, 2):
                raw = _cv2_jpeg(img, quality, SAMPLING[sampling], optimize, restart)
                want = _cv2_gray(raw)
                got = jpeg.decode_gray(raw)
                assert got.dtype == np.uint8 and got.shape == want.shape == (h, w)
                np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} opt {optimize} "
                                                                 f"rst {restart}")


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_matches_cv2(orientation):
    """An APP1 Exif segment spliced in after SOI, both byte orders: cv2
    applies orientations 1-8 and ignores other values; so does the port."""
    img = _image(np.random.default_rng(orientation), 23, 41, False)
    raw = _cv2_jpeg(img, 85)
    for big in (False, True):
        spliced = with_segment(raw, exif_app1(orientation, big))
        want = _cv2_gray(spliced)
        got = jpeg.decode_gray(spliced)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert jpeg.exif_orientation(b"Exif\x00\x00II") == 1


@pytest.mark.parametrize("sampling", [None, "444", "422", "420"])
def test_numpy_encoder_decodes_equally(sampling):
    """The test encoder's files (standard tables, restart intervals of 0, 1
    and 3 MCUs) decode in cv2 and in the port to the pixels that its islow
    IDCT gives."""
    rng = np.random.default_rng(3)
    for h, w in [(1, 1), (7, 9), (17, 33), (61, 45)]:
        y = _image(rng, h, w, False)
        for restart in (0, 1, 3):
            raw, want = encode_jpeg(y, 80, sampling, restart)
            np.testing.assert_array_equal(_cv2_gray(raw), want)
            np.testing.assert_array_equal(jpeg.decode_gray(raw), want)


def _segments(raw):
    """[(marker, offset of the segment)] up to SOS."""
    out, pos = [], 2
    while raw[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", raw[pos + 2:pos + 4])
        out.append((raw[pos + 1], pos))
        pos += 2 + length
    return out


def _swap_sof(raw, marker):
    ((_, pos),) = [(m, p) for m, p in _segments(raw) if m == 0xC0]
    return raw[:pos + 1] + bytes([marker]) + raw[pos + 2:]


def _set_precision(raw, bits):
    ((_, pos),) = [(m, p) for m, p in _segments(raw) if m == 0xC0]
    return raw[:pos + 4] + bytes([bits]) + raw[pos + 5:]


def _adobe(raw, transform):
    """The file with its JFIF APP0 replaced by an Adobe APP14 segment."""
    ((_, pos),) = [(m, p) for m, p in _segments(raw) if m == 0xE0]
    (length,) = struct.unpack(">H", raw[pos + 2:pos + 4])
    body = b"Adobe" + b"\x00\x64\x00\x00\x00\x00" + bytes([transform])
    seg = b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
    return raw[:pos] + seg + raw[pos + 2 + length:]


def _without(raw, marker):
    """The file without its first ``marker`` segment."""
    ((_, pos), *_) = [(m, p) for m, p in _segments(raw) if m == marker]
    (length,) = struct.unpack(">H", raw[pos + 2:pos + 4])
    return raw[:pos] + raw[pos + 2 + length:]


def _rgb_ids(raw):
    """The file's three components renamed R, G, B (frame and scan)."""
    ((_, pos),) = [(m, p) for m, p in _segments(raw) if m == 0xC0]
    out = bytearray(raw)
    for k, cid in enumerate(b"RGB"):
        out[pos + 10 + 3 * k] = cid
    sos = raw.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        out[sos + 5 + 2 * k] = cid
    return bytes(out)


def _cmyk():
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(buf, format="JPEG")
    return buf.getvalue()


def _oracle_gray(tmp_path, raw):
    """The JAX package's ``load_grayscale`` of ``raw`` as a file (cv2, then
    PIL), or None where it raises."""
    path = tmp_path / "oracle.jpg"
    path.write_bytes(raw)
    try:
        return jax_transforms.load_grayscale(str(path))
    except Exception:
        return None


def test_refused_formats_raise(tmp_path):
    """The formats cv2 and PIL refuse raise a ValueError naming them:
    lossless and arithmetic-coded progressive frame markers on a baseline
    file's scan (bad scan parameters for them), hierarchical frames, 12-bit
    samples, a file that is not a JPEG.  The formats this list held before
    the port read them (progressive files of cv2, an arithmetic-coded frame
    marker on a baseline scan, CMYK, RGB by an Adobe marker or by ids R, G, B)
    equal the JAX package's ``load_grayscale``."""
    rng = np.random.default_rng(0)
    gray = _cv2_jpeg(_image(rng, 40, 48, False))
    colour = _cv2_jpeg(_image(rng, 40, 48, True), sampling=SAMPLING["420"])
    cases = [
        (_cv2_jpeg(_image(rng, 40, 48, False), progressive=1), None),
        (_cv2_jpeg(_image(rng, 40, 48, True), progressive=1), None),
        (_swap_sof(gray, 0xC3), "corrupt JPEG \\(lossless scan parameters"),
        (_swap_sof(gray, 0xC9), None),
        (_swap_sof(gray, 0xCA), "corrupt JPEG \\(progressive scan parameters"),
        (_swap_sof(gray, 0xC5), "unsupported JPEG format: hierarchical"),
        (_swap_sof(_set_precision(gray, 12), 0xC1), "unsupported JPEG format: 12-bit samples"),
        (_cmyk(), None),
        (_adobe(colour, 0), None),
        (_rgb_ids(_without(colour, 0xE0)), None),
        (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
    ]
    for raw, match in cases:
        want = _oracle_gray(tmp_path, raw)
        if match:
            assert want is None, match
            with pytest.raises(ValueError, match=match):
                jpeg.decode_gray(raw, "x.jpg")
        else:
            np.testing.assert_array_equal(jpeg.decode_gray(raw, "x.jpg"), want)
    # an Adobe marker with transform 1 is YCbCr, which the port reads as cv2 does
    np.testing.assert_array_equal(jpeg.decode_gray(_adobe(colour, 1)),
                                  _cv2_gray(_adobe(colour, 1)))


@pytest.mark.parametrize("restart", [0, 3])
def test_truncated_and_corrupt_files_raise(tmp_path, restart):
    """A file cut before its first scan raises a ValueError that says
    truncated or corrupt, as cv2 and PIL refuse it; one cut inside its scan
    decodes as libjpeg decodes it (the rest of the file from a fake EOI
    marker), and so do a restart marker out of order (resynchronised) and a
    cut of the EOI marker alone.  A DC table of two codes of length 1, the
    second all ones, is refused as libjpeg refuses it."""
    raw = _cv2_jpeg(_image(np.random.default_rng(1), 64, 64, True), 90,
                    SAMPLING["420"], restart=restart)
    first_scan = raw.index(b"\xff\xda")
    for cut in sorted({4, 30, 200, len(raw) // 3, len(raw) // 2, len(raw) - 40, len(raw) - 2,
                       len(raw) - 1}):
        want = _oracle_gray(tmp_path, raw[:cut])
        if cut <= first_scan:
            assert want is None, cut
            with pytest.raises(ValueError, match="truncated|corrupt"):
                jpeg.decode_gray(raw[:cut], "cut.jpg")
        else:
            np.testing.assert_array_equal(jpeg.decode_gray(raw[:cut], "cut.jpg"), want)
    if restart:
        rst = raw.index(b"\xff\xd1")
        bad = raw[:rst + 1] + b"\xd5" + raw[rst + 2:]
        np.testing.assert_array_equal(jpeg.decode_gray(bad), _oracle_gray(tmp_path, bad))
    # a DC table of two codes of length 1, the second all ones
    ((_, pos), *_) = [(m, p) for m, p in _segments(raw) if m == 0xC4]
    (length,) = struct.unpack(">H", raw[pos + 2:pos + 4])
    body = b"\x00" + bytes([2] + [0] * 15) + b"\x00\x01"
    bad = raw[:pos] + b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body + \
        raw[pos + 2 + length:]
    assert _oracle_gray(tmp_path, bad) is None
    with pytest.raises(ValueError, match="Huffman table"):
        jpeg.decode_gray(bad)


def test_load_grayscale_sniffs_content(tmp_path):
    """`data.image.load_grayscale` goes by the bytes, as cv2.imread does: PNG
    bytes under a .jpg name and JPEG bytes under a .png name read as the
    JAX package's load_grayscale reads them; anything else raises."""
    rng = np.random.default_rng(2)
    g = _image(rng, 30, 20, False)
    (tmp_path / "a.jpg").write_bytes(encode_png(g, 0, 8))
    (tmp_path / "b.png").write_bytes(_cv2_jpeg(g, 70))
    (tmp_path / "c.jpg").write_bytes(b"GIF89a")
    for name in ("a.jpg", "b.png"):
        np.testing.assert_array_equal(image.load_grayscale(tmp_path / name),
                                      jax_transforms.load_grayscale(str(tmp_path / name)))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image.load_grayscale(tmp_path / "c.jpg")


def test_decoder_threads_agree():
    """Eight threads decoding at once (the loader's pool) give the images
    that one thread gives: the native tables are per thread."""
    rng = np.random.default_rng(4)
    raws = [_cv2_jpeg(_image(rng, 120 + 7 * i, 90 + 5 * i, i % 2 == 1), 60 + 4 * i,
                      SAMPLING["420"] if i % 2 else None, restart=i % 3) for i in range(16)]
    serial = [jpeg.decode_gray(r) for r in raws]
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(jpeg.decode_gray, raws * 4))
    for k, img in enumerate(threaded):
        np.testing.assert_array_equal(img, serial[k % len(raws)])
