"""The port's JPEG reader (`data/jpeg.py` over `native/jpeg_decode.cc`)
against the JAX package's ``load_grayscale`` (``cv2.imread(...,
IMREAD_GRAYSCALE)``, then PIL's ``convert("L")``) on every format beyond
baseline: progressive Huffman with any scan script (block smoothing where it
stops short of Al = 0), arithmetic-coded sequential and progressive files
with DAC conditioning, lossless files at 2-8 bits with every predictor,
CMYK / YCCK / RGB, luma sampled below a chroma component; cv2's and PIL's
own files; seeded sweeps of cut points and byte corruptions; the formats
both refuse, each pinned to the module docstring; the damaged files whose
digests ``chip_smoke.py`` phase 18 checks on the card, pinned to cv2."""

import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_codecs import (CORPUS, DAMAGED, DAMAGED_SHA256, Frame, adobe, corpus_file,
                          damaged_file, full_progression, gray_digest, jpeg_frame, lossless_frame,
                          reconstruct, write_jpeg)
from torch_mura_tree import xray_like
from xfmamba_tpu.data import transforms as jax_transforms
from xfmamba_tpu_torch.data import image, jpeg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SAMPLINGS = {"gray": [(1, 1)], "444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
             "420": [(2, 2), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
             "411": [(4, 1), (1, 1), (1, 1)]}


def _planes(seed, h=40, w=56, n=3):
    g = xray_like(np.random.default_rng(seed), h, w)
    return [g, np.roll(g, 5, 1), 255 - g, np.clip(g.astype(int) // 2 + 60, 0, 255)][:n]


def oracle(path):
    """The JAX package's gray image of the file, or None where it raises."""
    try:
        return jax_transforms.load_grayscale(str(path))
    except Exception:
        return None


def parity(tmp_path, raw, name="x.jpg"):
    """Hold the port to the oracle on ``raw``: the same array, or a
    ValueError naming the file where the oracle raises.  Returns the
    oracle's array (None when it refused)."""
    path = tmp_path / name
    path.write_bytes(raw)
    want = oracle(path)
    if want is None:
        with pytest.raises(ValueError) as e:
            image.load_grayscale(path)
        assert str(path) in str(e.value)
        return None
    got = image.load_grayscale(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=name)
    return want


def frame(kind, seed=0, quality=80, h=40, w=56):
    samp = SAMPLINGS[kind]
    return jpeg_frame(_planes(seed, h, w, len(samp)), samp, quality=quality)


SCRIPTS = {
    "full": lambda n: full_progression(n),
    "no-refinement": lambda n: full_progression(n, refine=False),
    "dc-only": lambda n: [(tuple(range(n)), 0, 0, 0, 0)],
    "dc-al2": lambda n: [(tuple(range(n)), 0, 0, 0, 2)],
    "short-of-al0": lambda n: full_progression(n)[:1 + 2 * n],
    "bands": lambda n: [(tuple(range(n)), 0, 0, 0, 1)] + [((c,), lo, hi, 0, 1) for c in range(n)
                                                          for lo, hi in ((1, 2), (3, 9),
                                                                         (10, 63))]
    + [(tuple(range(n)), 0, 0, 1, 0)] + [((c,), 1, 63, 1, 0) for c in range(n)],
}


@pytest.mark.parametrize("coding", ["huffman", "arith"])
@pytest.mark.parametrize("kind", ["gray", "420", "422", "440"])
@pytest.mark.parametrize("restart", [0, 3])
def test_progressive_scripts(tmp_path, coding, kind, restart):
    """Every scan script, Huffman and arithmetic-coded: equal to the oracle,
    and to the islow IDCT of the coefficients where the script is complete;
    block smoothing where it is not."""
    fr, q = frame(kind, restart + len(kind))
    n = len(fr.comps)
    for name, script in SCRIPTS.items():
        raw = write_jpeg(fr, q, script(n), coding=coding, progressive=True, restart=restart)
        want = parity(tmp_path, raw, f"{name}.jpg")
        if name in ("full", "bands"):
            np.testing.assert_array_equal(want, reconstruct(fr, q))


@pytest.mark.parametrize("kind", sorted(SAMPLINGS))
@pytest.mark.parametrize("restart", [0, 1, 4])
def test_arithmetic_sequential(tmp_path, kind, restart):
    """Arithmetic-coded sequential files (SOF9) with and without a DAC
    segment: equal to the oracle and to the islow pixels."""
    fr, q = frame(kind, restart)
    comps = tuple(range(len(fr.comps)))
    for dac in (None, {"dc": {c: (1, 3 + c) for c in comps}, "ac": {c: 2 + 7 * c for c in comps}}):
        raw = write_jpeg(fr, q, [(comps, 0, 63, 0, 0)], coding="arith", restart=restart, dac=dac)
        np.testing.assert_array_equal(parity(tmp_path, raw), reconstruct(fr, q))


@pytest.mark.parametrize("precision", range(2, 9))
def test_lossless(tmp_path, precision):
    """Lossless files (SOF3) at 2-8 bits, each predictor, a point transform,
    a restart interval of two rows: the written samples."""
    g = xray_like(np.random.default_rng(precision), 24, 30).astype(np.int64)
    samples = g >> (8 - precision)
    for psv in range(1, 8):
        pt = psv % min(precision, 3)
        restart = 2 * 30 if psv % 2 else 0
        raw = write_jpeg(lossless_frame(samples, precision), {}, [((0,),)], psv=psv, pt=pt,
                         restart=restart)
        want = parity(tmp_path, raw, f"p{psv}.jpg")
        np.testing.assert_array_equal(want, samples >> pt << pt)


@pytest.mark.parametrize("transform", [None, 0, 1, 2, 7])
@pytest.mark.parametrize("sampling", [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                      [(1, 1), (2, 1), (2, 1), (1, 1)]])
def test_four_components(tmp_path, transform, sampling):
    """CMYK and YCCK: no Adobe marker (CMYK), transform 0 (CMYK), 2 (YCCK)
    and others (libjpeg takes YCCK), sequential and progressive."""
    fr, q = jpeg_frame(_planes(transform or 0, n=4), sampling)
    app = () if transform is None else (adobe(transform),)
    parity(tmp_path, write_jpeg(fr, q, [((0, 1, 2, 3), 0, 63, 0, 0)], app=app), "seq.jpg")
    parity(tmp_path, write_jpeg(fr, q, full_progression(4), progressive=True, app=app),
           "prog.jpg")


@pytest.mark.parametrize("sampling", [[(1, 1), (2, 2), (1, 1)], [(1, 2), (2, 1), (1, 1)],
                                      [(1, 1), (1, 2), (2, 1)], [(2, 1), (4, 2), (1, 1)],
                                      [(3, 1), (1, 1), (1, 1)], [(1, 1), (1, 1), (3, 2)]])
def test_colour_models_and_samplings(tmp_path, sampling):
    """Luma sampled below a chroma component (upsampled for gray), RGB by
    an Adobe marker with transform 0 or by ids R, G, B (libjpeg's RGB ->
    gray after upsampling every component), YCbCr by JFIF or transform 1."""
    planes = _planes(sum(h * v for h, v in sampling))
    fr, q = jpeg_frame(planes, sampling)
    scans = [((0, 1, 2), 0, 63, 0, 0)]
    parity(tmp_path, write_jpeg(fr, q, scans), "ycc.jpg")
    parity(tmp_path, write_jpeg(fr, q, scans, app=(adobe(0),)), "rgb_adobe.jpg")
    parity(tmp_path, write_jpeg(fr, q, scans, app=(adobe(1),)), "ycc_adobe.jpg")
    fr_ids, q_ids = jpeg_frame(planes, sampling, ids=[82, 71, 66])
    parity(tmp_path, write_jpeg(fr_ids, q_ids, scans, app=()), "rgb_ids.jpg")
    parity(tmp_path, write_jpeg(fr, q, full_progression(3), coding="arith", progressive=True,
                                app=(adobe(0),)), "rgb_arith.jpg")


def _cv2_file(img, **params):
    flags = [cv2.IMWRITE_JPEG_QUALITY, params.get("quality", 90), cv2.IMWRITE_JPEG_PROGRESSIVE,
             params.get("progressive", 0), cv2.IMWRITE_JPEG_RST_INTERVAL, params.get("restart", 0),
             cv2.IMWRITE_JPEG_OPTIMIZE, params.get("optimize", 0)]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def _pil_file(img, mode, **kw):
    import io
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [40, 75, 95])
def test_cv2_and_pil_files(tmp_path, quality):
    """The writers JAX's users have: cv2's progressive files (gray and
    colour, restart intervals, optimised tables), PIL's progressive, CMYK
    and RGB-model files."""
    g = xray_like(np.random.default_rng(quality), 61, 47)
    colour = np.stack(_planes(quality, 61, 47), 2)
    for img in (g, colour):
        for restart in (0, 2):
            parity(tmp_path, _cv2_file(img, quality=quality, progressive=1, restart=restart,
                                       optimize=restart // 2))
    for mode in ("L", "RGB", "CMYK"):
        for progressive in (False, True):
            parity(tmp_path, _pil_file(colour, mode, quality=quality, progressive=progressive))
    parity(tmp_path, _pil_file(colour, "RGB", quality=quality, subsampling=0,
                               progressive=True))


def _bases():
    g = _planes(9, 48, 64)
    fr, q = jpeg_frame(g[:1], [(1, 1)], quality=60)
    f3, q3 = jpeg_frame(g, SAMPLINGS["420"], quality=60)
    return {
        "baseline-gray": write_jpeg(fr, q, [((0,), 0, 63, 0, 0)]),
        "baseline-gray-rst2": write_jpeg(fr, q, [((0,), 0, 63, 0, 0)], restart=2),
        "baseline-420-rst1": write_jpeg(f3, q3, [((0, 1, 2), 0, 63, 0, 0)], restart=1),
        "progressive-gray": write_jpeg(fr, q, full_progression(1), progressive=True),
        "progressive-gray-rst3": write_jpeg(fr, q, full_progression(1), progressive=True,
                                            restart=3),
        "progressive-420-rst2": write_jpeg(f3, q3, full_progression(3), progressive=True,
                                           restart=2),
        "arith-progressive-420": write_jpeg(f3, q3, full_progression(3), coding="arith",
                                            progressive=True, restart=4),
    }


@pytest.mark.parametrize("base", sorted(_bases()))
def test_cut_sweep(tmp_path, base):
    """Files cut at seeded points, from inside the headers to the last byte:
    cv2 reads a cut scan as libjpeg does (a fake EOI marker; zeros past the
    data; the previous scan's accuracy and block smoothing for the rows a
    progressive scan did not reach), and refuses a file cut before its first
    scan; the port does the same."""
    raw = _bases()[base]
    rng = np.random.default_rng(len(base))
    cuts = sorted(set(rng.integers(3, len(raw), 36).tolist() + [len(raw) - 1, len(raw) - 2]))
    for cut in cuts:
        parity(tmp_path, raw[:cut], f"cut{cut}.jpg")


@pytest.mark.parametrize("base", sorted(_bases()))
def test_corruption_sweep(tmp_path, base):
    """One to three bytes replaced at seeded places (some by 0xFF, which
    makes markers): bad Huffman codes decode as 0, lost restart markers
    resynchronise, a damaged table or marker segment is refused where cv2
    and PIL refuse it."""
    raw = _bases()[base]
    rng = np.random.default_rng(100 + len(base))
    for t in range(40):
        b = bytearray(raw)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(2, len(raw)))] = 0xFF if rng.random() < 0.2 else \
                int(rng.integers(0, 256))
        parity(tmp_path, bytes(b), f"t{t}.jpg")


# what cv2 and PIL both refuse: (how the file is made, the message's phrase)
def _refused():
    g = _planes(5)
    fr, q = jpeg_frame(g[:1], [(1, 1)])
    base = write_jpeg(fr, q, [((0,), 0, 63, 0, 0)])
    sof = base.index(b"\xff\xc0")

    def swap(marker, raw=base):
        i = raw.index(b"\xff\xc0")
        return raw[:i + 1] + bytes([marker]) + raw[i + 2:]

    twelve = jpeg_frame(g[:1], [(1, 1)], precision=12)
    cases = [
        (write_jpeg(*twelve, [((0,), 0, 63, 0, 0)]), "12-bit samples .extended sequential"),
        (write_jpeg(*twelve, full_progression(1), progressive=True), "12-bit samples .progressive"),
        (base[:sof + 4] + b"\x0c" + base[sof + 5:], "12-bit samples .baseline"),
        (write_jpeg(*twelve, [((0,), 0, 63, 0, 0)], coding="arith"),
         "12-bit samples .arithmetic-coded sequential"),
        (base[:sof + 1] + b"\xcb" + base[sof + 2:], "arithmetic-coded lossless"),
        (base[:sof + 5] + b"\x00\x00" + base[sof + 7:], "height given by a DNL marker"),
        (base[:2] + b"\x12" + base[3:], "not a PNG or JPEG"),
        (base[:sof + 8], "corrupt JPEG"),
        (base[:base.index(b"\xff\xda") + 4], "corrupt JPEG"),
    ]
    for bits in range(9, 17):
        s = (g[0].astype(np.int64) << (bits - 8))
        cases.append((write_jpeg(lossless_frame(s, bits), {}, [((0,),)], psv=1),
                      f"{bits}-bit samples .lossless"))
    names = {0xC5: "hierarchical .differential sequential", 0xC6: "hierarchical .differential "
             "progressive", 0xC7: "hierarchical .differential lossless", 0xC8: "JPG extension",
             0xCD: "hierarchical .differential sequential", 0xCE: "hierarchical .differential "
             "progressive", 0xCF: "hierarchical .differential lossless"}
    cases += [(swap(m), name) for m, name in names.items()]
    f2, q2 = jpeg_frame(g[:2], [(1, 1), (1, 1)])
    cases.append((write_jpeg(f2, q2, [((0, 1), 0, 63, 0, 0)]), "2 components"))
    f5, q5 = jpeg_frame(g + [g[0], g[1]], [(1, 1)] * 5)
    cases.append((write_jpeg(f5, q5, [((0, 1, 2, 3), 0, 63, 0, 0), ((4,), 0, 63, 0, 0)]),
                  "5 components"))
    # RGB (every component needed) with a component at 2 of the frame's 3
    comps = [dict(id=k + 1, h=h, v=1, tq=0, coef=np.zeros((5, 9, 64), np.int64))
             for k, h in enumerate((3, 2, 1))]
    frac = Frame(72, 40, comps)
    cases.append((write_jpeg(frac, {0: np.full(64, 8)}, [((0,), 0, 63, 0, 0), ((1,), 0, 63, 0, 0),
                                                        ((2,), 0, 63, 0, 0)], app=(adobe(0),)),
                  "fractional upsampling"))
    # a progressive scan whose Huffman table no segment defines
    prog = write_jpeg(fr, q, full_progression(1), progressive=True)
    out, pos = prog[:2], 2
    while prog[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", prog[pos + 2:pos + 4])
        out += b"" if prog[pos + 1] == 0xC4 else prog[pos:pos + 2 + length]
        pos += 2 + length
    cases.append((out + prog[pos:], "Huffman table 0 is not defined"))
    return cases


def test_refused_formats_match_the_oracle(tmp_path):
    """Each format that cv2 and PIL refuse raises a ValueError naming the
    file and the format, and the module docstring's refusal list names it."""
    doc = " ".join(jpeg.__doc__.split())
    for k, (raw, phrase) in enumerate(_refused()):
        path = tmp_path / f"r{k}.jpg"
        path.write_bytes(raw)
        assert oracle(path) is None, phrase
        with pytest.raises(ValueError, match=phrase) as e:
            image.load_grayscale(path)
        assert str(path) in str(e.value)
    for phrase in ("12-bit samples", "lossless files at 9 to 16 bits",
                   "arithmetic-coded lossless", "hierarchical", "JPG marker", "DNL marker",
                   "two or five and more components", "fractional ratio",
                   "cut or corrupt before their first scan", "progressive or lossless scan "
                   "whose Huffman table no segment defines"):
        assert phrase in doc, phrase


def test_damaged_digests_pinned_to_cv2(tmp_path):
    """The cut, corrupt, short-of-Al-0 and CMYK / YCCK / RGB files phase 18
    of chip_smoke.py checks on the card by digest: cv2 gives the digests in
    tests/torch_codecs.py, and the port gives cv2's images."""
    for name in DAMAGED:
        want = parity(tmp_path, damaged_file(name, (96, 80)), f"{name}.jpg")
        assert want is not None, name
    for name in DAMAGED:
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(damaged_file(name))
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        assert gray_digest(want) == DAMAGED_SHA256[name], name
        assert gray_digest(image.load_grayscale(path)) == DAMAGED_SHA256[name], name


def test_corpus_decodes_to_the_encoders_reconstruction(tmp_path):
    """Phase 18's intact files, small: the port and cv2 give the islow
    pixels of the final coefficients, or the written samples."""
    for name in CORPUS:
        raw, want = corpus_file(name, (48, 72))
        path = tmp_path / (name + (".png" if name.startswith("png") else ".jpg"))
        path.write_bytes(raw)
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), want, name)
        np.testing.assert_array_equal(image.load_grayscale(path), want, name)
