"""The port's copies of the NYU breast cropping (`data/nyu_cropping.py`) and
the optimal-window search (`data/optimal_centers.py`) against the JAX
package's on the CPU: every public function on blob images and synthetic
mammograms (tests/torch_datasets_tree.py), with and without the window
constraints, on both breast sides and both views.  Integer results are
equal; the covered fractions agree to 1e-12."""

import numpy as np
import pytest
import scipy.ndimage as ndi

from torch_datasets_tree import mammogram
from xfmamba_tpu.data import nyu_cropping as jax_nyu
from xfmamba_tpu.data import optimal_centers as jax_oc
from xfmamba_tpu_torch.data import nyu_cropping as nyu
from xfmamba_tpu_torch.data import optimal_centers as oc

WINDOW_KEYS = ("window_dim_y", "window_dim_x", "best_center_y", "best_center_x")


def _blob_image(seed, shape=(48, 36)):
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.float32)
    for _ in range(3):
        cy, cx = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        h, w = rng.integers(5, 18), rng.integers(5, 15)
        img[max(0, cy - h // 2):cy + h, max(0, cx - w // 2):cx + w] = 1.0
    return img


def _same_window(got, want):
    for k in WINDOW_KEYS:
        assert int(got[k]) == int(want[k]), (k, got, want)
    assert abs(got["fraction"] - want["fraction"]) < 1e-12


def _constraints(module, kind):
    if kind == "right":
        return module.get_rightmost_pixel_constraint(40)
    if kind == "bottomright":
        return module.get_bottomrightmost_pixel_constraint(40, 50)
    return None


def _mammogram(seed, side, shape=(120, 80)):
    """A synthetic mammogram scaled to [-1, 1] (background -1), oriented
    to ``side``."""
    img, _ = mammogram(np.random.default_rng(seed), *shape, side.upper())
    return img.astype(np.float32) / 32767.5 - 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("step", [1, 3])
def test_window_info_matches_jax(seed, step):
    img = _blob_image(seed)
    com = np.array([20, 17])
    for wd in [(8, 8), (15, 11), (48, 36), (64, 48)]:
        _same_window(oc.get_image_optimal_window_info(img, com, np.array(wd), step=step),
                     jax_oc.get_image_optimal_window_info(img, com, np.array(wd), step=step))


@pytest.mark.parametrize("kind", ["right", "bottomright"])
def test_constrained_window_info_matches_jax(kind):
    img = _blob_image(5, (60, 44))
    com, wd = np.array([30, 22]), np.array([20, 16])
    _same_window(
        oc.get_image_optimal_window_info(img, com, wd, tl_br_constraint=_constraints(oc, kind)),
        jax_oc.get_image_optimal_window_info(img, com, wd,
                                             tl_br_constraint=_constraints(jax_oc, kind)))


@pytest.mark.parametrize("kind", [None, "right"])
def test_images_window_info_rows_match_jax(kind):
    """One row per window size: the port's dicts, JAX's DataFrame rows."""
    img = _blob_image(7)
    com = np.array([24, 18])
    sizes = [np.array([10, 10]), np.array([20, 14]), np.array([48, 36])]
    got = oc.get_images_optimal_window_info(img, com, sizes,
                                            tl_br_constraint=_constraints(oc, kind))
    want = jax_oc.get_images_optimal_window_info(img, com, sizes,
                                                 tl_br_constraint=_constraints(jax_oc, kind))
    assert len(got) == len(want) == len(sizes)
    for g, (_, w) in zip(got, want.iterrows()):
        _same_window(g, w)
    np.testing.assert_array_equal(oc.get_image_cumsum(img), jax_oc.get_image_cumsum(img))


@pytest.mark.parametrize("iterations", [0, 1, 3, 7])
def test_morphology_matches_jax_and_scipy(iterations):
    """The one-pass erosion and dilation equal JAX's and scipy's iterated
    ones; the largest component equals JAX's."""
    mask = _blob_image(iterations + 11, (40, 33)) > 0
    mask[5, 5:30] = True                       # a thin line the erosion removes
    for ours, ref, scipy_op in ((nyu.fast_binary_erosion, jax_nyu.fast_binary_erosion,
                                 ndi.binary_erosion),
                                (nyu.fast_binary_dilation, jax_nyu.fast_binary_dilation,
                                 ndi.binary_dilation)):
        got = ours(mask, iterations)
        np.testing.assert_array_equal(got, ref(mask, iterations))
        if iterations:
            np.testing.assert_array_equal(got, scipy_op(mask, iterations=iterations))
    np.testing.assert_array_equal(nyu.largest_connected_component(mask),
                                  jax_nyu.largest_connected_component(mask))


@pytest.mark.parametrize("window", [(8, 8), (13, 21), (40, 33), (64, 64)])
def test_optimal_window_center_matches_jax(window):
    mask = _blob_image(3, (40, 33)) > 0
    assert nyu.optimal_window_center(mask, window) == jax_nyu.optimal_window_center(mask,
                                                                                   window)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("seed", [0, 1])
def test_crop_from_largest_connected_matches_jax(side, seed):
    """The crop box, the rightmost and bottommost points and the distance
    from the starting side, on a mammogram with its background at 0."""
    img = _mammogram(seed, side) + 1.0
    assert nyu.crop_img_from_largest_connected(img, side, erode_dialate=True,
                                               iterations=5, buffer_size=10) == \
        jax_nyu.crop_img_from_largest_connected(img, side, erode_dialate=True, iterations=5,
                                                buffer_size=10)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("view", ["cc", "mlo"])
def test_find_crop_center_matches_jax(side, view):
    """The crop center, the breast's box and the window search's result."""
    img = _mammogram(4, side)
    kw = dict(crop_size=(48, 32), side=side, view=view, iterations=5, buffer_size=10)
    center, bbox, info = nyu.find_crop_center(img, **kw)
    jcenter, jbbox, jinfo = jax_nyu.find_crop_center(img, **kw)
    assert (center, bbox) == (jcenter, jbbox)
    _same_window(info, jinfo)
