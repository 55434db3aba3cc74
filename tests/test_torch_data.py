"""The port's data path on the CPU against the JAX package's (which decodes
and warps with cv2): PNG decoding (bitwise against ``cv2.imread(...,
IMREAD_GRAYSCALE)`` for every supported kind and filter type, files written
by the test helper, cv2 and PIL; the unsupported kinds raise), the native
unfilter against its numpy twin, resize, crop, flip, rotation and the
composed transforms against ``xfmamba_tpu.data.transforms``, the u8
normalisation against ``xfmamba_tpu.native``, the loader batch for batch
against JAX's ``TwoViewLoader``, and the MURA tables and patient split
against JAX's pandas / sklearn code."""

import gc
import os
import subprocess
import sys
import threading
import time
import weakref

import cv2
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from torch_mura_tree import ArrayPairs, encode_png, image_file, write_mura_tree
from xfmamba_tpu import native as jax_native
from xfmamba_tpu.data import loader as jax_loader
from xfmamba_tpu.data import mura as jax_mura
from xfmamba_tpu.data import transforms as jax_tf
from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data import TwoViewLoader, TwoViewSamples
from xfmamba_tpu_torch.data import mura, png
from xfmamba_tpu_torch.data import transforms as tf
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# one level of the u8 input after Normalize(0.456, 0.224), and float32 slack
LEVEL = 1 / (255 * 0.224) + 1e-6
KINDS = ["gray8", "rgb8", "rgba8", "palette8", "graya8", "gray16", "graya16"]


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 1, 0, 2]])
def test_png_matches_cv2(tmp_path, kind, filters, monkeypatch):
    """Every supported colour type and bit depth, one filter type on every
    row (then all five mixed): bitwise equal to cv2's gray decode, through
    the native unfilter and through its numpy twin."""
    import torch_mura_tree
    real = torch_mura_tree.encode_png
    monkeypatch.setattr(torch_mura_tree, "encode_png",
                        lambda *a, **kw: real(*a, **dict(kw, filters=filters)))
    path = str(tmp_path / f"{kind}.png")
    image_file(np.random.default_rng(len(kind)), path, kind, 37, 53)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    got = png.load_grayscale(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.load_grayscale(path, native.png_unfilter_plain), want)


def test_png_written_by_cv2_and_pil(tmp_path):
    """Files from the two writers JAX's data users have: cv2 (gray, RGB,
    16-bit gray) and PIL (L, RGB, RGBA, LA, P, optimized L)."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (41, 29, 3), dtype=np.uint8)
    files = {"cv_gray": lambda p: cv2.imwrite(p, rgb[:, :, 0]),
             "cv_rgb": lambda p: cv2.imwrite(p, rgb),
             "cv_gray16": lambda p: cv2.imwrite(p, rgb[:, :, 0].astype(np.uint16) * 257 + 3),
             "pil_l": lambda p: Image.fromarray(rgb[:, :, 0]).save(p),
             "pil_rgb": lambda p: Image.fromarray(rgb).save(p),
             "pil_rgba": lambda p: Image.fromarray(rgb).convert("RGBA").save(p),
             "pil_la": lambda p: Image.fromarray(rgb).convert("LA").save(p),
             "pil_p": lambda p: Image.fromarray(rgb).convert("P").save(p),
             "pil_l_optimized": lambda p: Image.fromarray(rgb[:, :, 1]).save(p, optimize=True)}
    for name, write in files.items():
        path = str(tmp_path / f"{name}.png")
        write(path)
        np.testing.assert_array_equal(png.load_grayscale(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE), err_msg=name)


@pytest.mark.parametrize("case,match", [
    (dict(colour=2, depth=16, channels=3), "colour type 2 .RGB. at bit depth 16"),
    (dict(colour=6, depth=16, channels=4), "colour type 6 .RGBA. at bit depth 16"),
    (dict(colour=0, depth=1), "bit depth 1"),
    (dict(colour=0, depth=2), "bit depth 2"),
    (dict(colour=0, depth=4), "bit depth 4"),
    (dict(colour=3, depth=4, palette=True), "palette. at bit depth 4"),
    (dict(colour=0, depth=8, interlace=1), "Adam7"),
    (dict(colour=0, depth=8, bad_crc=True), "bad CRC"),
    (dict(colour=0, depth=8, truncate=20), "truncated"),
])
def test_png_unsupported_kinds_raise(tmp_path, case, match):
    """16-bit colour, bit depths below 8, Adam7, a bad CRC and a truncated
    stream raise a ValueError naming the file and the format."""
    case = dict(case)
    ch, pal = case.pop("channels", 1), case.pop("palette", False)
    depth = case["depth"]
    top = (1 << depth) - 1
    px = np.random.default_rng(2).integers(0, top + 1, (9, 11, ch)).astype(
        np.uint16 if depth == 16 else np.uint8)
    raw = encode_png(px[:, :, 0] if ch == 1 else px,
                     palette=np.zeros((16, 3), np.uint8) if pal else None, **case)
    path = tmp_path / "bad.png"
    path.write_bytes(raw)
    with pytest.raises(ValueError, match=match) as e:
        png.load_grayscale(str(path))
    assert str(path) in str(e.value)


def test_png_not_a_png(tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(40))
    with pytest.raises(ValueError, match="not a PNG"):
        png.load_grayscale(str(path))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_numpy_twin(bpp):
    """The C++ unfilter against its numpy twin on random filtered bytes and
    filter types, every type in every position; a type past 4 raises in
    both."""
    rng = np.random.default_rng(bpp)
    h, rowbytes = 23, bpp * 17
    data = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    data[:, 0] = rng.permutation(np.arange(h) % 5)
    got = native.png_unfilter(data.reshape(-1), h, rowbytes, bpp)
    np.testing.assert_array_equal(got, native.png_unfilter_plain(data.reshape(-1), h, rowbytes,
                                                                 bpp))
    data[7, 0] = 5
    for fn in (native.png_unfilter, native.png_unfilter_plain):
        with pytest.raises(ValueError, match="row 7 has filter type 5"):
            fn(data.reshape(-1), h, rowbytes, bpp)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A host library that does not compile raises with the compiler's
    output; nothing falls back to numpy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DXFM_BROKEN", "-include",
                                                                 "no_such_header.h"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(224, 224), (256, 256), (32, 32)])
@pytest.mark.parametrize("src", [(380, 512), (512, 300), (57, 83), (223, 224)])
def test_resize_matches_cv2(size, src):
    """At most 1 level from cv2's INTER_LINEAR (the port follows its fixed
    point, so it may match bit for bit)."""
    img = cv2.GaussianBlur(np.random.default_rng(3).integers(0, 256, src, dtype=np.uint8),
                           (0, 0), 1.5)
    img[::7] = 255 - img[::7]
    want = jax_tf.resize(img, size)
    got = tf.resize(img, size)
    assert got.dtype == np.uint8 and got.shape == size
    assert np.abs(got.astype(int) - want).max() <= 1


def test_random_rotation_matches_cv2():
    """Angles in ±30° drawn by both packages from equally seeded generators,
    cv2's nearest warp against the port's: at most 1 pixel in 10,000
    differs, and the generators end in the same state."""
    rng = np.random.default_rng(4)
    diff = total = 0
    for k in range(40):
        shape = (224, 224) if k % 2 else (int(rng.integers(20, 260)), int(rng.integers(20, 260)))
        img = rng.integers(1, 256, shape, dtype=np.uint8)
        ra, rb = np.random.default_rng(k), np.random.default_rng(k)
        want = jax_tf.random_rotation(img, 30.0, ra)
        got = tf.random_rotation(img, 30.0, rb)
        assert ra.bit_generator.state == rb.bit_generator.state
        diff += int((got != want).sum())
        total += img.size
    assert diff <= total / 10_000, (diff, total)


def test_crop_flip_and_draws_equal():
    """Crop (with padding), flip and the rotation angle take the same
    generator calls as JAX's and give equal images."""
    img = np.random.default_rng(5).integers(0, 256, (30, 20), dtype=np.uint8)
    for seed in range(20):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for size in (16, 24, 32):
            np.testing.assert_array_equal(tf.random_crop(img, size, rb),
                                          jax_tf.random_crop(img, size, ra))
        np.testing.assert_array_equal(tf.random_hflip(img, rb), jax_tf.random_hflip(img, ra))
        assert rb.uniform(-30, 30) == ra.uniform(-30, 30)
        assert ra.bit_generator.state == rb.bit_generator.state


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", [224, 32])
def test_two_view_transform_matches_jax(train, size):
    """The MURA transforms, train and eval, for the same generator: within
    one input level (1 / (255 x 0.224) + 1e-6) of JAX's."""
    make = (tf.mura_train_transform, tf.mura_eval_transform)[not train]
    jmake = (jax_tf.mura_train_transform, jax_tf.mura_eval_transform)[not train]
    img = cv2.GaussianBlur(np.random.default_rng(6).integers(0, 256, (300, 410),
                                                              dtype=np.uint8), (0, 0), 2)
    for seed in range(4):
        got = make((size, size))(img, np.random.default_rng(seed))
        want = jmake((size, size))(img, np.random.default_rng(seed))
        assert got.dtype == np.float32 and got.shape == want.shape == (size, size, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=LEVEL)


def test_normalize_matches_jax_native():
    x = np.random.default_rng(7).integers(0, 256, (3, 19, 23), dtype=np.uint8)
    for mean, std in ((0.456, 0.224), (0.0, 1.0)):
        np.testing.assert_allclose(native.normalize_u8(x, mean, std),
                                   jax_native.normalize_u8(x, mean, std), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

def _join_process_pools():
    """JAX's loader leaves its process pool shutting down in the background;
    wait for every pool's manager thread, so that no later fork copies a
    pool's lock while it is held (the fault the port's loader repairs, see
    `test_process_loader_joins_its_pools`)."""
    from concurrent.futures import process
    for thread in list(process._threads_wakeups):
        thread.join()


@pytest.mark.parametrize("use_processes", [False, True])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_matches_jax(use_processes, shuffle, drop_last):
    """Batches bitwise equal to JAX's TwoViewLoader over two epochs, same
    samples, load function and transform (the train transform draws from
    the per-sample generators), threads or processes, with the padded last
    batch and its ``n_valid``."""
    rng = np.random.default_rng(8)
    images = [rng.integers(0, 256, (40, 36), dtype=np.uint8) for _ in range(7)]
    samples = [(i % 7, (i * 3) % 7, i % 2) for i in range(11)]
    load, transform = ArrayPairs(images), tf.mura_train_transform((32, 32))
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=5,
              use_processes=use_processes)
    ours = TwoViewLoader(TwoViewSamples(samples, load, transform), **kw)
    ref = jax_loader.TwoViewLoader(jax_loader.TwoViewSamples(samples, load, transform), **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(ours), list(ref)
        _join_process_pools()
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and a["n_valid"] == b["n_valid"]
            for k in ("image1", "image2", "label"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    if not drop_last:
        assert got[-1]["n_valid"] == 3 and got[-1]["image1"].shape[0] == 4
        assert not got[-1]["image1"][3:].any()


def test_process_loader_joins_its_pools():
    """Repair of the JAX loader: worker processes over several epochs, the
    port's loader joins each epoch's pool before the next one forks, so the
    program exits.  (JAX's shuts the pool down in the background: a later
    fork can copy the old pool's wake-up lock while it is held, and that
    epoch's workers then hang at their exit, and the program with them.)"""
    code = ("import numpy as np\n"
            "from xfmamba_tpu_torch.data import TwoViewLoader, TwoViewSamples\n"
            "from xfmamba_tpu_torch.data.transforms import mura_train_transform\n"
            "from torch_mura_tree import ArrayPairs\n"
            "imgs = [np.full((20, 24), i, np.uint8) for i in range(5)]\n"
            "ds = TwoViewSamples([(i % 5, 0, i % 2) for i in range(9)], ArrayPairs(imgs),\n"
            "                    mura_train_transform((16, 16)))\n"
            "for procs in (True, False, True):\n"
            "    ld = TwoViewLoader(ds, 2, shuffle=True, num_workers=2, use_processes=procs)\n"
            "    for _ in range(3):\n"
            "        assert sum(b['n_valid'] for b in ld) == 9\n"
            "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.path.join(repo, "tests")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, check=False)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


class _CountingPairs(ArrayPairs):
    """`ArrayPairs` that counts the samples it has loaded (threads only)."""

    def __init__(self, images):
        super().__init__(images)
        self.loaded = 0
        self._lock = threading.Lock()

    def __call__(self, sample):
        with self._lock:
            self.loaded += 1
        return super().__call__(sample)


def _long_epoch(load, n_batches=40, use_processes=False):
    samples = [(i % 3, (i + 1) % 3, i % 2) for i in range(2 * n_batches)]
    return TwoViewLoader(TwoViewSamples(samples, load), 2, num_workers=2, prefetch=2,
                         use_processes=use_processes)


def test_loader_keeps_few_batches_in_flight():
    """Repair of the JAX loader, which submits a whole epoch at once: over
    an epoch of 40 batches and a slow consumer, the workers never run more
    than ``prefetch + num_workers`` batches ahead of it."""
    load = _CountingPairs([np.full((8, 8), i, np.uint8) for i in range(3)])
    loader = _long_epoch(load)
    ahead = []
    for k, _ in enumerate(loader):
        time.sleep(0.002)       # room for the workers to run ahead, were they free to
        ahead.append(load.loaded / loader.batch_size - (k + 1))
    assert len(ahead) == len(loader) == 40
    assert 0 <= max(ahead) <= loader.prefetch + loader.num_workers


@pytest.mark.parametrize("use_processes", [False, True])
def test_loader_drops_consumed_batches(use_processes):
    """Host memory stays bounded over an epoch: once the consumer has moved
    on, nothing of the loader (a list of finished futures, say) holds a
    batch it has yielded; at most the latest one is alive."""
    alive = []
    refs = []
    loader = _long_epoch(ArrayPairs([np.full((8, 8), i, np.uint8) for i in range(3)]),
                         n_batches=30, use_processes=use_processes)
    for batch in loader:
        refs.append(weakref.ref(batch["image1"]))
        del batch
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
    assert len(refs) == 30 and max(alive) <= 1


# ---------------------------------------------------------------------------
# MURA tables and the patient split
# ---------------------------------------------------------------------------

def _df(rows):
    return pd.DataFrame(rows, columns=list(mura.COLUMNS))


def _tuples(df):
    return [tuple(r) for r in df.itertuples(index=False, name=None)]


def test_study_pairs_policy():
    assert mura.study_pairs(["a"]) == jax_mura.study_pairs(["a"]) == [("a", "a")]
    for names in (["b", "a"], list("cab"), list("abcd")):
        assert mura.study_pairs(names) == jax_mura.study_pairs(names)


def test_tables_match_jax(tmp_path):
    """The synthetic tree (with a study of each size 1-3, an unlabeled
    study, non-integer labels, a blank line and an image outside every
    study) read by both packages: the same rows in the same order."""
    csvs, _ = write_mura_tree(str(tmp_path), n_studies=9, n_valid=3, sizes=((8, 12), (8, 12)),
                              seed=3)
    with open(csvs[0], "a") as f:
        f.write("MURA-v1.1/train/XR_HAND/patient99999/study1_negative/image1.png\n"
                "  MURA-v1.1/elsewhere/image9.png\n")
    with open(csvs[1], "a") as f:
        f.write("MURA-v1.1/train/XR_HAND/patient99999/study1_negative/,x\n\n"
                "MURA-v1.1/train/XR_HAND/patient99998/study1_negative/, -\n")
    for img_csv, lbl_csv in (csvs[:2], csvs[2:]):
        got = mura.read_mura_tables(img_csv, lbl_csv, str(tmp_path))
        want = _tuples(jax_mura.read_mura_tables(img_csv, lbl_csv, str(tmp_path)))
        assert got == want and len(got) > 0


def _rows(patients, rng, unknown=0):
    """Table rows: ``patients`` [(id, [study labels])], 1-3 pairs a study."""
    rows = []
    for pid, labels in patients:
        for s, label in enumerate(labels):
            study = f"/d/train/XR_ELBOW/{pid}/study{s}"
            for j in range(int(rng.integers(1, 4))):
                rows.append((f"{study}/image{j}.png", f"{study}/image{j}.png", label, study,
                             pid, "ELBOW"))
    for u in range(unknown):
        study = f"/d/train/XR_WRIST/anon{u}/study0"
        rows.append((f"{study}/image0.png",) * 2 + (u % 2, study, mura.UNKNOWN_PATIENT,
                                                    "WRIST"))
    return rows


SPLIT_CASES = {
    # 40 patients, both classes: sklearn's StratifiedShuffleSplit
    "stratified": lambda rng: [(f"patient{i:05d}", [int(rng.integers(0, 2))])
                               for i in range(40)],
    # one class: ShuffleSplit
    "one_class": lambda rng: [(f"patient{i:05d}", [1]) for i in range(30)],
    # a class of one patient: StratifiedShuffleSplit raises, the fallback
    "too_few": lambda rng: [(f"patient{i:05d}", [0]) for i in range(20)] + [("patient99999", [1])],
    # 12 patients: a test split of 1 < 2 classes raises, the fallback
    "small": lambda rng: [(f"patient{i:05d}", [i % 2]) for i in range(12)],
    # ties: two studies of each label, the first seen decides
    "ties": lambda rng: [(f"patient{i:05d}", [i % 2, 1 - i % 2, 0, 1][:2 + 2 * (i % 3 == 0)])
                         for i in range(25)] + [(f"patient{i:05d}", [1, 1, 0]) for i in range(25, 30)],
    # three classes, rows in no particular patient order
    "three_classes": lambda rng: [(f"patient{int(i):05d}", [int(i) % 3])
                                  for i in rng.permutation(60)],
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("seed", [0, 42, 7])
def test_patient_split_matches_jax(case, seed):
    """The train / val rows of JAX's pandas + sklearn split, row for row,
    with UNKNOWN patients (forced into train) mixed in."""
    rng = np.random.default_rng(seed)
    rows = _rows(SPLIT_CASES[case](rng), rng, unknown=3)
    got = mura.patient_level_split(rows, seed)
    want = jax_mura.patient_level_split(_df(rows), seed)
    for g, w in zip(got, want):
        assert g == _tuples(w)
    assert {r[4] for r in rows if r[4] == mura.UNKNOWN_PATIENT} <= {r[4] for r in got[0]}


def test_patient_labels_tie_rule():
    """The patient label of pandas ``value_counts().idxmax()``: the most
    frequent, ties to the label seen first, patients in sorted order."""
    rows = [(0, 0, lab, 0, pid, 0) for pid, lab in
            [("b", 1), ("a", 0), ("b", 0), ("a", 1), ("c", 2), ("c", 0), ("c", 0), ("b", 0)]]
    want = (_df(rows).groupby("patient_id")["label"]
            .agg(lambda x: x.value_counts().idxmax()).reset_index())
    assert mura.patient_labels(rows) == [tuple(r) for r in want.itertuples(index=False)]
    assert mura.patient_labels(rows) == [("a", 0), ("b", 0), ("c", 0)]


def test_split_of_too_few_patients_raises():
    rows = _rows([("patient00001", [1])], np.random.default_rng(0))
    with pytest.raises(ValueError):
        jax_mura.patient_level_split(_df(rows), 0)
    with pytest.raises(ValueError):
        mura.patient_level_split(rows, 0)


def test_create_data_loaders_match_jax(tmp_path):
    """The three loaders over a synthetic tree: the same samples as JAX's;
    the eval batches within 1e-6 of JAX's (decode, resize, normalise) and
    the train batches within one input level; a body-part filter on the
    test loader; device preprocessing raises."""
    csvs, _ = write_mura_tree(str(tmp_path), n_studies=24, n_valid=6,
                              sizes=((40, 70), (40, 70)), seed=4)
    cfg = dict(root_dir=str(tmp_path), seed=3, image_size=(32, 32), batch_size=4,
               num_workers=2)
    ours = mura.create_data_loaders(*csvs, cfg)
    ref = jax_mura.create_data_loaders(*csvs, cfg)
    for a, b, tol in zip(ours, ref, (LEVEL, 1e-6, 1e-6)):
        assert a.dataset.samples == b.dataset.samples and len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x["n_valid"] == y["n_valid"]
            np.testing.assert_array_equal(x["label"], y["label"])
            for k in ("image1", "image2"):
                np.testing.assert_allclose(x[k], y[k], rtol=0, atol=tol)
    part = mura.create_data_loaders(*csvs, cfg, body_part="WRIST")[2]
    assert part.dataset.samples == jax_mura.create_data_loaders(
        *csvs, cfg, body_part="WRIST")[2].dataset.samples
    assert {os.path.basename(os.path.dirname(os.path.dirname(os.path.dirname(s[0]))))
            for s in part.dataset.samples} == {"XR_WRIST"}
    # with the device stage both packages' loaders stage the same uint8
    staged = mura.create_data_loaders(*csvs, dict(cfg, device_preprocess=True))
    ref = jax_mura.create_data_loaders(*csvs, dict(cfg, device_preprocess=True))
    for a, b in zip(staged, ref):
        for x, y in zip(a, b):
            for k in ("image1", "image2"):
                assert x[k].dtype == np.uint8
                np.testing.assert_array_equal(x[k], y[k])
