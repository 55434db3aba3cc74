"""The port's DICOM reader (`data/dicom.py`, in place of pydicom) and its
DDSM view loader against the JAX package: arrays written by the DICOM
writer of tests/torch_datasets_tree.py read back exactly in both VR
encodings, past sequences of undefined length; the refused formats; and
`data.ddsm.load_view` on a ``.dcm`` against JAX's on the same pixels saved
as ``.npy``, with the mask resize, a rescale factor, the NYU crop and the
overlay."""

import os

import cv2
import numpy as np
import pytest

from torch_datasets_tree import encode_dicom, write_ddsm_tree
from xfmamba_tpu.data import ddsm as jax_ddsm
from xfmamba_tpu.data import nyu_cropping as jax_nyu_cropping
from xfmamba_tpu_torch.data import ddsm, dicom, transforms
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16])
@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("sequences", [True, False])
def test_written_arrays_read_back(dtype, explicit, sequences):
    """Every dtype, in explicit and implicit VR, with and without the
    sequences (nested, undefined and defined length, an icon image with its
    own Rows and Pixel Data) before the pixels: the same array, dtype and
    shape, bitwise (odd sizes pad the 8-bit pixel data by a byte)."""
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    for h, w in [(1, 1), (7, 9), (64, 33)]:
        px = rng.integers(info.min, info.max, (h, w), endpoint=True).astype(dtype)
        got = dicom.decode_pixels(encode_dicom(px, explicit, sequences=sequences))
        assert got.dtype == np.dtype(dtype) and got.shape == (h, w)
        np.testing.assert_array_equal(got, px)


@pytest.mark.parametrize("stored", [12, 15])
def test_signed_values_sign_extend_from_bits_stored(stored):
    """Signed 16-bit data of ``stored`` bits whose high bits are not set:
    the reader sign-extends from Bits Stored; unsigned data of the same
    bits is returned as stored."""
    rng = np.random.default_rng(stored)
    values = rng.integers(-(1 << (stored - 1)), 1 << (stored - 1), (20, 30))
    raw16 = (values & ((1 << stored) - 1)).astype(np.uint16)
    got = dicom.decode_pixels(encode_dicom(raw16, bits_stored=stored, signed=True))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, values)
    got = dicom.decode_pixels(encode_dicom(raw16, bits_stored=stored))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, raw16)


def test_refused_formats_raise(tmp_path):
    """Each format the reader does not take raises a ValueError naming it."""
    px = np.arange(12, dtype=np.uint16).reshape(3, 4)
    cases = [
        (encode_dicom(px, syntax="1.2.840.10008.1.2.2"), "1.2.840.10008.1.2.2 \\(explicit VR big"),
        (encode_dicom(px, syntax="1.2.840.10008.1.2.4.50"), "JPEG baseline"),
        (encode_dicom(px, syntax="1.2.840.10008.1.2.5"), "RLE lossless"),
        (encode_dicom(px, syntax="1.2.840.10008.1.2.1.99"), "deflated"),
        (encode_dicom(px, encapsulated=True), "encapsulated \\(compressed\\) under transfer "
                                              "syntax 1.2.840.10008.1.2.1"),
        (encode_dicom(px, samples=3), "3 samples per pixel"),
        (encode_dicom(px, frames=2), "2 frames"),
        (encode_dicom(px.astype(np.uint32).view(np.uint32)), "32 bits allocated"),
        (b"\x00" * 128 + b"NOPE", "not a DICOM file"),
        (encode_dicom(px)[:-5], "truncated DICOM pixel data"),
        (encode_dicom(px)[:300], "truncated"),
    ]
    for raw, match in cases:
        with pytest.raises(ValueError, match=match):
            dicom.decode_pixels(raw, "x.dcm")
    path = tmp_path / "one.dcm"
    path.write_bytes(encode_dicom(px, frames=1))
    np.testing.assert_array_equal(dicom.read_pixels(path), px)


@pytest.mark.parametrize("src,dst", [((1000, 800), (224, 224)), ((3000, 2000), (2400, 1600)),
                                     ((450, 448), (224, 224)), ((448, 448), (224, 224)),
                                     ((37, 41), (100, 90)), ((275, 30), (445, 366)),
                                     ((563, 277), (47, 584))])
def test_float_resize_matches_cv2(src, dst):
    """`resize` on float32 against ``cv2.resize(INTER_LINEAR)`` (which the
    JAX package calls on DDSM's images and masks), at downscales, an exact
    halving, upscales and mixed ones: integer-valued 16-bit images, values
    in [1, 2) and values across zero bitwise (1 ulp would do); 0/1 masks
    thresholded at 0.5 alike, and of the pixels whose cv2 value lies within
    1 ulp of 0.5, none differs."""
    rng = np.random.default_rng(sum(src + dst))
    images = [rng.integers(0, 65536, src).astype(np.float32),
              (rng.random(src) + 1).astype(np.float32),
              (rng.random(src) * 4000 - 100).astype(np.float32)]
    for img in images:
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = transforms.resize(img, dst)
        assert got.dtype == np.float32 and got.shape == dst
        np.testing.assert_array_equal(got, want)
    mask = (rng.random(src) < 0.3).astype(np.float32)
    want = cv2.resize(mask, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = transforms.resize(mask, dst)
    near = np.abs(want - np.float32(0.5)) <= np.spacing(np.float32(0.5))
    assert int((near & (got != want)).sum()) == 0
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


@pytest.fixture(scope="module")
def ddsm_tree(tmp_path_factory):
    """Subjects of a DDSM tree whose every .dcm has its pixels as .npy beside
    it: the port reads the .dcm, JAX (without pydicom) the .npy."""
    root = str(tmp_path_factory.mktemp("ddsm"))
    base, meta, cases = write_ddsm_tree(root, n_patients=4, size=(600, 380), npy=True, seed=2)
    subjects = ddsm.load_subjects(cases, meta, base)
    assert len(subjects) == 4
    return subjects


@pytest.mark.parametrize("rescale", [None, 0.5, 0.37])
@pytest.mark.parametrize("crop", [False, True])
def test_load_view_matches_jax(ddsm_tree, rescale, crop):
    """`load_view` reading the .dcm files equals JAX's reading the same
    pixels from .npy: image and mask bitwise, masks of another size resized
    (float32, cv2's float path) and OR-ed, the rescale's float resize and
    the mask's > 0.5, the NYU crop; the overlay without the crop too.  The
    rescaled soft masks (before > 0.5) are held to cv2's within 1 ulp, and
    the pixels where they differ within 1 ulp of 0.5, which the threshold
    could split, are counted: none."""
    from xfmamba_tpu.data import transforms as jax_t
    from xfmamba_tpu_torch.data import transforms
    for subj in ddsm_tree:
        for name in ("cc", "mlo"):
            view = subj["views"][name]
            assert all(p.endswith(".dcm") and os.path.exists(p)
                       for p in [view["image_file"], *view["mask_files"]])
            for overlay in (False, True) if not crop else (False,):
                got = ddsm.load_view(view, subj["side"], crop, rescale, overlay)
                want = jax_ddsm.load_view(view, subj["side"], crop, rescale, overlay)
                np.testing.assert_array_equal(got[0], want[0])
                if not crop:
                    np.testing.assert_array_equal(got[1], want[1])
            if rescale is not None:
                image = jax_ddsm.read_pixels(view["image_file"])
                mask = np.zeros(image.shape, bool)
                for mp in view["mask_files"]:
                    m = jax_ddsm.read_pixels(mp)
                    mask |= (jax_t.resize(m, image.shape) if m.shape != image.shape else m) > 0
                hw = (int(image.shape[0] * rescale), int(image.shape[1] * rescale))
                soft = jax_t.resize(mask.astype(np.float32), hw)
                ours = transforms.resize(mask.astype(np.float32), hw)
                ulp = np.spacing(np.abs(soft))
                assert np.all(np.abs(ours - soft) <= ulp)
                near = np.abs(soft - np.float32(0.5)) <= np.spacing(np.float32(0.5))
                assert int((near & (ours != soft)).sum()) == 0


@pytest.mark.parametrize("rescale", [None, 0.9])
def test_crop_and_overlay_blend_the_cropped_mask(ddsm_tree, rescale):
    """With both the crop and the overlay, JAX blends nothing where the crop
    is smaller than the image (its mask keeps the uncropped shape); the
    port crops the mask with the image and blends the ROI into the crop:
    JAX's cropped image, with JAX's mask cut by the same box blended halfway
    to the crop's maximum (the box from JAX's NYU crop)."""
    blended = cropped = 0
    for subj in ddsm_tree:
        for name in ("cc", "mlo"):
            view = subj["views"][name]
            got, got_mask = ddsm.load_view(view, subj["side"], True, rescale, True)
            plain, _ = jax_ddsm.load_view(view, subj["side"], True, rescale, False)
            jax_overlay, _ = jax_ddsm.load_view(view, subj["side"], True, rescale, True)
            full, full_mask = jax_ddsm.load_view(view, subj["side"], False, rescale,
                                                 False)
            (top, bottom, left, right), *_ = \
                jax_nyu_cropping.crop_img_from_largest_connected(full, subj["side"])
            mask = full_mask[top:bottom, left:right]
            mx = plain.max() or 1.0
            np.testing.assert_array_equal(got_mask, mask)
            want = np.where(mask, 0.5 * plain + 0.5 * mx, plain)
            np.testing.assert_array_equal(got, want)
            if plain.shape != full.shape:
                np.testing.assert_array_equal(jax_overlay, plain)    # JAX: no overlay
                cropped += 1
                blended += int(mask.sum())
            else:
                np.testing.assert_array_equal(jax_overlay, want)
    assert cropped and blended


def test_load_fn_and_scale_match_jax(ddsm_tree):
    """`DDSMLoadFn` (crop, rescale) gives JAX's uint8 views and label."""
    for crop, rescale in ((False, None), (True, 0.5)):
        ours = ddsm.make_load_fn(ddsm_tree, crop, rescale)
        ref = jax_ddsm.make_load_fn(ddsm_tree, crop, rescale)
        for i in range(len(ddsm_tree)):
            for g, w in zip(ours(i), ref(i)):
                np.testing.assert_array_equal(g, w)
