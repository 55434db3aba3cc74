"""The port's CheXpert, hip X-ray and CBIS-DDSM data paths against the JAX
package's on synthetic trees (tests/torch_datasets_tree.py) that carry the
quirks the loaders inherit from pandas: empty and -1 labels, a missing
label column, no ``Frontal/Lateral`` column, a study with one view, a
second frontal, rows out of order, backslash paths, a path without a study,
PNG bytes under a .jpg name, "Exclude" rows, empty classifications.  The
samples, the splits and the first batches of every loader (same seed) are
equal; so are the tables' typing rules and the timing report's text."""

import io

import numpy as np
import pandas as pd
import pytest

from torch_datasets_tree import write_chexpert_tree, write_ddsm_tree, write_hip_tree
from xfmamba_tpu.data import chexpert as jax_chexpert
from xfmamba_tpu.data import ddsm as jax_ddsm
from xfmamba_tpu.data import hipxray as jax_hip
from xfmamba_tpu.utils import profiling as jax_profiling
from xfmamba_tpu_torch.data import chexpert, ddsm, hipxray
from xfmamba_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = dict(seed=42, image_size=(32, 32), batch_size=4, eval_batch_size=4, num_workers=2)
# one input level of the normalised hip views (as tests/test_torch_data.py)
LEVEL = 1 / (255 * 0.224) + 1e-6


def _same_samples(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_array_equal(np.asarray(g[2]), np.asarray(w[2]))
        assert np.asarray(g[2]).dtype == np.asarray(w[2]).dtype


def _same_first_batches(ours, ref, atol=(0, 0, 0)):
    """The first batch of each loader equal to JAX's: labels and counts
    exactly, views within the loader's ``atol`` (0: bitwise)."""
    assert len(ours) == len(ref)
    for a, b, tol in zip(ours, ref, atol):
        assert len(a) == len(b) and len(a.dataset) == len(b.dataset)
        if not len(a):
            continue
        ba, bb = next(iter(a)), next(iter(b))
        assert set(ba) == set(bb)
        for k in ba:
            if k.startswith("image") and tol:
                np.testing.assert_allclose(ba[k], bb[k], rtol=0, atol=tol, err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(ba[k]), np.asarray(bb[k]), err_msg=k)


@pytest.fixture(scope="module")
def chexpert_trees(tmp_path_factory):
    trees = {}
    for name, kw in (("quirks", {}), ("no_fracture_no_view", dict(drop_columns=("Fracture",),
                                                                  view_column=False))):
        root = str(tmp_path_factory.mktemp(name))
        csv_path, _ = write_chexpert_tree(root, n_patients=14, size=(44, 36), seed=3, **kw)
        trees[name] = (root, csv_path)
    return trees


@pytest.mark.parametrize("tree", ["quirks", "no_fracture_no_view"])
@pytest.mark.parametrize("drop_no_finding", [False, True])
def test_chexpert_samples_match_jax(chexpert_trees, tree, drop_no_finding):
    """`build_samples` equals JAX's (pandas) sample for sample: paths, label
    vectors (float32, empty -> 0, -1 kept, a missing column -> 0)."""
    root, csv_path = chexpert_trees[tree]
    got = chexpert.build_samples([csv_path], [root], drop_no_finding)
    want = jax_chexpert.build_samples([csv_path], [root], drop_no_finding)
    _same_samples(got, want)
    vecs = np.stack([s[2] for s in got])
    assert vecs.shape[1] == 13 + (not drop_no_finding)
    assert (vecs == -1).any() and (vecs == 0).any() and (vecs == 1).any()


@pytest.mark.parametrize("n", [0, 1, 7, 100, 1003])
def test_chexpert_split_matches_jax(n):
    for seed in (0, 42):
        assert chexpert.reference_split_indices(n, seed) == \
            jax_chexpert.reference_split_indices(n, seed)


def test_chexpert_loaders_match_jax(chexpert_trees):
    """The first batch of the train, val and test loaders (the train
    transform's crop, flip and rotation drawn alike) equals JAX's."""
    root, csv_path = chexpert_trees["quirks"]
    ours = chexpert.create_train_val_test_data_loaders([root], [csv_path], CFG)
    ref = jax_chexpert.create_train_val_test_data_loaders([root], [csv_path], CFG)
    _same_first_batches(ours, ref)


@pytest.fixture(scope="module")
def hip_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hip"))
    return write_hip_tree(root, n=20, size=(40, 34), seed=4)


def test_hip_samples_and_loaders_match_jax(hip_tree):
    """`build_samples` (the "Exclude" rows dropped in any case, an empty
    fracture class kept, an empty final class and a missing pair skipped)
    and the label mapping equal JAX's; so do the loaders' first batches
    (normalised as MURA's: the eval batch within 1e-6, which JAX's native
    normalisation rounds apart, the train batch within one input level, as
    `tests/test_torch_data.py` holds MURA's)."""
    images, csv_path = hip_tree
    got, mapping = hipxray.build_samples(images, csv_path)
    want, want_mapping = jax_hip.build_samples(images, csv_path)
    _same_samples(got, want)
    assert mapping == want_mapping and len(mapping) == 3
    ours = hipxray.create_data_loaders(images, csv_path, CFG)
    ref = jax_hip.create_data_loaders(images, csv_path, CFG)
    assert ours[2] == ref[2]
    _same_first_batches(ours[:2], ref[:2], (LEVEL, 1e-6))


def test_hip_float_image_numbers_find_nothing_as_in_jax(hip_tree, tmp_path):
    """An empty ``Image_no`` makes pandas read the column as floats, so the
    numbers name "1.0 AP.jpg": JAX finds no pair, and neither does the
    port."""
    images, csv_path = hip_tree
    text = open(csv_path).read().rstrip("\n") + "\n,2019-01-01,A1,Normal\n"
    bad = tmp_path / "floats.csv"
    bad.write_text(text)
    for build in (jax_hip.build_samples, hipxray.build_samples):
        with pytest.raises(RuntimeError, match="no valid AP/Lateral pairs"):
            build(images, str(bad))


@pytest.mark.parametrize("cells", [
    ["1", "2", "30"], ["007", "8"], ["1", "", "3"], ["1.5", "2"], ["a", "1"], ["NA", "3"],
    ["x", "", "y"], ["-1", "0"], ["1e3", "2"], ["", ""]])
def test_pandas_column_typing(cells):
    """`pandas_column` types a column as pandas' read_csv does: ints, floats
    with NaN, or strings with NaN."""
    frame = pd.read_csv(io.StringIO("c,d\n" + "\n".join(f"{c},0" for c in cells) + "\n"))
    want = frame["c"].tolist()
    got = hipxray.pandas_column(cells)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float) and np.isnan(w):
            assert isinstance(g, float) and np.isnan(g)
        else:
            assert g == w and type(g) is type(w.item() if hasattr(w, "item") else w)


@pytest.fixture(scope="module")
def ddsm_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddsm"))
    return write_ddsm_tree(root, n_patients=12, size=(90, 60), npy=True, seed=5)


def test_ddsm_subjects_split_and_loaders_match_jax(ddsm_tree):
    """`load_subjects` (the UID join, the two-view grouping), the 80/20
    split and the first batches of both loaders equal JAX's; the port reads
    the .dcm files, JAX (without pydicom) the .npy beside them."""
    base, meta, cases = ddsm_tree
    got = ddsm.load_subjects(cases, meta, base)
    want = jax_ddsm.load_subjects(cases, meta, base)
    assert got == want and len(got) == 12
    assert ddsm.reference_split(got) == jax_ddsm.reference_split(want)
    assert {ddsm.subject_label(s) for s in got} == {0, 1}
    ours = ddsm.create_data_loaders(cases, meta, base, CFG)
    ref = jax_ddsm.create_data_loaders(cases, meta, base, CFG)
    _same_first_batches(ours, ref)


def test_ddsm_reads_png_at_its_depth(tmp_path):
    """Without a .dcm, `read_pixels` takes the .npy, else the .png at its
    own depth (8 or 16 bits), as JAX's PIL does; a colour PNG gives PIL's
    (H, W, 3) array, as JAX's fallback does."""
    from PIL import Image
    rng = np.random.default_rng(0)
    for dtype in (np.uint8, np.uint16):
        px = rng.integers(0, np.iinfo(dtype).max, (9, 7)).astype(dtype)
        Image.fromarray(px).save(tmp_path / "1-1.png")
        np.testing.assert_array_equal(ddsm.read_pixels(str(tmp_path / "1-1.dcm")),
                                      jax_ddsm.read_pixels(str(tmp_path / "1-1.dcm")))
    Image.fromarray(rng.integers(0, 255, (4, 4, 3)).astype(np.uint8)).save(tmp_path / "1-1.png")
    got = ddsm.read_pixels(str(tmp_path / "1-1.dcm"))
    assert got.shape == (4, 4, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_ddsm.read_pixels(str(tmp_path / "1-1.dcm")))
    with pytest.raises(FileNotFoundError):
        ddsm.read_pixels(str(tmp_path / "2-1.dcm"))


@pytest.mark.parametrize("times", [[], [0.5], [0.0123, 0.0456, 0.0311]])
def test_timing_report_matches_jax(times):
    for bs in (1, 16):
        stats = profiling.timing_stats(times, bs)
        want = jax_profiling.timing_stats(times, bs)
        assert stats.keys() == want.keys()
        assert profiling.format_timing_report(stats, "CheXpert inference timing") == \
            jax_profiling.format_timing_report(want, "CheXpert inference timing")
