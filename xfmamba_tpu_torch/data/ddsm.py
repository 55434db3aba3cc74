"""CBIS-DDSM two-view (CC + MLO) mammogram pipeline (port of
``xfmamba_tpu/data/ddsm.py``; the DICOMs read by `data/dicom.py` in place
of pydicom).

Behaviour follows ``libs/dataset_ddsmxray_twoview.py`` of the reference:
- case CSVs joined to ``metadata.csv`` through the Series UID -> (file
  location, number of images) (`:81-91`, `:155-172`); DICOMs found as
  ``1-<n>.dcm``;
- grouped by (patient, side, abnormality); kept only with both a CC and an
  MLO view (`:215-250`);
- pathology BENIGN / BENIGN_WITHOUT_CALLBACK -> 0, MALIGNANT -> 1
  (`:20-25`, `:268-275`);
- ROI masks OR-combined, resized to the image where their size differs
  (`:301-313`);
- an optional rescale and the NYU largest-connected-component crop
  (`:327-341`);
- the 80/20 split stratified by abnormality type with ``random.seed(42)``
  shuffles (`:704-743`), the same stdlib-random recipe.

`read_pixels` takes the ``.dcm`` where it exists, else a pre-converted
``.npy``, else a ``.png`` beside it as PIL's ``np.asarray(Image.open(...))``
gives it (`png.decode_native`: any mode, at its own depth), as the JAX
package does without pydicom.  One fault of the JAX package is not copied: with
both the crop and the overlay, JAX blends nothing (its mask keeps the
uncropped shape, so the shape test fails); here the mask is cropped with
the image and the ROI blended into the crop.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from xfmamba_tpu_torch.data import dicom, nyu_cropping, png
from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples, staged_or
from xfmamba_tpu_torch.data.transforms import TwoViewTransform, resize

ASSESSMENT_MAP = {"BENIGN_WITHOUT_CALLBACK": "benign", "BENIGN": "benign",
                  "MALIGNANT": "malignant"}
SIDE_MAP = {"LEFT": "left", "RIGHT": "right"}
VIEW_MAP = {"CC": "cc", "MLO": "mlo"}


def _extract_series_uid(path: str) -> str:
    parts = path.strip().split("/")
    if len(parts) < 2:
        raise ValueError(f"path {path!r} not in expected format")
    return parts[-2]


def _normalize_subdir(p: str) -> str:
    p = p.replace("\\", "/")
    if p.startswith("./"):
        p = p[2:]
    return os.path.normpath(p)


def read_metadata(metadata_csv: str) -> Dict[str, Tuple[str, int]]:
    out = {}
    with open(metadata_csv) as f:
        for row in csv.DictReader(f):
            out[row["Series UID"]] = (row["File Location"], int(row["Number of Images"]))
    return out


def _exists_any(dcm_path: str) -> bool:
    if os.path.exists(dcm_path):
        return True
    base = os.path.splitext(dcm_path)[0]
    return any(os.path.exists(base + ext) for ext in (".png", ".npy"))


def load_subjects(main_csv_files, metadata_csv, base_dir, check_exists: bool = True) -> List[Dict]:
    """Group the case rows into two-view subjects (see the module docstring)."""
    uid_map = read_metadata(metadata_csv)
    if isinstance(main_csv_files, str):
        main_csv_files = [main_csv_files]

    def resolve(rel):
        uid = _extract_series_uid(rel)
        if uid not in uid_map:
            return None
        loc, num = uid_map[uid]
        return os.path.join(_normalize_subdir(os.path.join(base_dir, loc)), f"1-{num}.dcm")

    groups: Dict[Tuple, Dict] = {}
    for csv_file in main_csv_files:
        with open(csv_file) as f:
            for line in csv.DictReader(f):
                pid = line["patient_id"]
                side = SIDE_MAP.get(line["left or right breast"].upper(),
                                    line["left or right breast"].lower())
                view = VIEW_MAP.get(line["image view"].upper(), line["image view"].lower())
                abnormality = line["abnormality type"].lower()
                key = (pid, side, view, abnormality)
                g = groups.setdefault(key, dict(
                    patient_id=pid, side=side, view=view, abnormality_type=abnormality,
                    assessment_label=line["pathology"], image_file=None, mask_files=[]))
                img = resolve(line["image file path"].strip())
                mask = resolve(line["ROI mask file path"].strip())
                if img is None or mask is None:
                    continue
                if check_exists and not (_exists_any(img) and _exists_any(mask)):
                    continue
                if g["image_file"] is None:
                    g["image_file"] = img
                g["mask_files"].append(mask)

    merged: Dict[Tuple, Dict] = {}
    for (pid, side, view, abn), g in groups.items():
        m = merged.setdefault((pid, side, abn), dict(
            patient_id=pid, side=side, abnormality_type=abn,
            assessment_label=g["assessment_label"], views={}))
        m["views"][view] = dict(image_file=g["image_file"], mask_files=g["mask_files"])
    return [m for m in merged.values()
            if "cc" in m["views"] and "mlo" in m["views"]
            and m["views"]["cc"]["image_file"] and m["views"]["mlo"]["image_file"]]


def read_pixels(dcm_path: str) -> np.ndarray:
    """A DICOM's stored pixel values as float32; where the ``.dcm`` does not
    exist, the ``.npy`` or the ``.png`` (PIL's array of it) beside it."""
    if os.path.exists(dcm_path):
        return dicom.read_pixels(dcm_path).astype(np.float32)
    base = os.path.splitext(dcm_path)[0]
    if os.path.exists(base + ".npy"):
        return np.load(base + ".npy").astype(np.float32)
    if os.path.exists(base + ".png"):
        with open(base + ".png", "rb") as f:
            return png.decode_native(f.read(), base + ".png").astype(np.float32)
    raise FileNotFoundError(dcm_path)


def load_view(view_data: Dict, side: str, crop: bool = False,
              rescale_factor: Optional[float] = None, overlay_mask: bool = False):
    """(image, mask) of one view: the image (float32), the masks OR-ed
    (bool; each resized to the image where its size differs, then > 0); an
    optional rescale (mask: resized as float32, then > 0.5), the NYU crop
    (`:288-341`; the mask cropped with it) and the Crop-Test dataset's
    overlay, which blends the ROI halfway to the image's maximum (`:621`)."""
    image = read_pixels(view_data["image_file"])
    mask = np.zeros(image.shape, bool)
    for mp in view_data["mask_files"]:
        m = read_pixels(mp)
        if m.shape != image.shape:
            m = resize(m, image.shape[:2])
        mask |= m > 0
    if rescale_factor is not None:
        new_hw = (int(image.shape[0] * rescale_factor), int(image.shape[1] * rescale_factor))
        image = resize(image, new_hw)
        mask = resize(mask.astype(np.float32), new_hw) > 0.5
    if crop:
        (top, bottom, left, right), *_ = nyu_cropping.crop_img_from_largest_connected(image, side)
        image = image[top:bottom, left:right]
        mask = mask[top:bottom, left:right]
    if overlay_mask:
        mx = image.max() or 1.0
        image = np.where(mask, 0.5 * image + 0.5 * mx, image)
    return image, mask


def subject_label(subj: Dict) -> int:
    return 0 if ASSESSMENT_MAP[subj["assessment_label"]] == "benign" else 1


def reference_split(subjects: List[Dict]):
    """80/20 per-abnormality split with random.seed(42) (`:704-743`)."""
    calc = [i for i, s in enumerate(subjects) if s["abnormality_type"] == "calcification"]
    mass = [i for i, s in enumerate(subjects) if s["abnormality_type"] == "mass"]
    random.seed(42)
    random.shuffle(calc)
    random.shuffle(mass)
    cs, ms = int(0.8 * len(calc)), int(0.8 * len(mass))
    return calc[:cs] + mass[:ms], calc[cs:] + mass[ms:]


def _scale_to_uint8(img: np.ndarray) -> np.ndarray:
    hi = img.max() or 1.0
    return np.clip(img / hi * 255.0, 0, 255).astype(np.uint8)


class DDSMLoadFn:
    """The two-view load function: a subject's index -> (CC u8, MLO u8,
    int32 label).  A class, not a closure, so the process loader can send
    it to its workers."""

    def __init__(self, subjects, crop=False, rescale_factor=None, overlay_mask=False):
        self.subjects = subjects
        self.crop = crop
        self.rescale_factor = rescale_factor
        self.overlay_mask = overlay_mask

    def __call__(self, sample):
        subj = self.subjects[sample]
        cc, _ = load_view(subj["views"]["cc"], subj["side"], self.crop, self.rescale_factor,
                          self.overlay_mask)
        mlo, _ = load_view(subj["views"]["mlo"], subj["side"], self.crop, self.rescale_factor,
                           self.overlay_mask)
        return _scale_to_uint8(cc), _scale_to_uint8(mlo), np.int32(subject_label(subj))


def make_load_fn(subjects, crop=False, rescale_factor=None, overlay_mask=False):
    return DDSMLoadFn(subjects, crop, rescale_factor, overlay_mask)


def create_data_loaders(main_csv_files, metadata_csv, base_dir, config, crop_size=None,
                        rescale_factor=None):
    """(train, val) loaders (``create_ddsmxray_data_loader``, `:674-760`):
    no crop and no normalisation in the transforms (`:676-692`)."""
    subjects = load_subjects(main_csv_files, metadata_csv, base_dir)
    tr_i, va_i = reference_split(subjects)
    size = tuple(config["image_size"])
    tt, et = staged_or(
        config,
        TwoViewTransform(size, crop=None, normalize_mean=None, normalize_std=None, train=True),
        TwoViewTransform(size, train=False, normalize_mean=None, normalize_std=None))
    load = make_load_fn(subjects, crop=crop_size is not None, rescale_factor=rescale_factor)
    nw = config.get("num_workers", 4)
    procs = bool(config.get("loader_processes"))
    train_loader = TwoViewLoader(TwoViewSamples(tr_i, load, tt), config["batch_size"],
                                 shuffle=True, drop_last=True, num_workers=nw,
                                 seed=config["seed"], use_processes=procs)
    val_loader = TwoViewLoader(TwoViewSamples(va_i, load, et), config["batch_size"],
                               shuffle=False, num_workers=nw, seed=config["seed"],
                               use_processes=procs)
    return train_loader, val_loader
