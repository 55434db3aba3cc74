"""Hip X-ray two-view (AP + Lateral) dataset (port of
``xfmamba_tpu/data/hipxray.py`` with ``csv`` in place of pandas).

Behaviour follows ``libs/dataset_hipxray_twoview.py`` of the reference:
- pairs by the file names "NNN AP.jpg" / "NNN Lateral.jpg", the image
  number zero-padded to 3 digits (`:41-59`);
- rows whose ``Fracture_Classification`` is "exclude" in any case dropped
  (`:33-34`); an empty one is kept;
- labels numbered by the sorted unique ``Final_Classification`` values
  (`:66-74`); rows with an empty one, or without both images, skipped;
- the train/val split of a ``default_rng(seed)`` permutation.

What JAX's pandas does and `pandas_column` does by hand: a column of
integers only reads as integers, one of numbers with an empty cell or a
decimal point as floats (so ``Image_no`` 7 names "007 AP.jpg", but in a
column with an empty cell it reads 7.0 and names "7.0 AP.jpg", which JAX
then does not find either), anything else as strings; the labels sort as
numbers or as strings accordingly.

With ``device_preprocess`` the loaders stage uint8 at the image size, as
the other datasets' do, and the card runs MURA's stage.  JAX's hip loader
never reads the flag (``xfmamba_tpu/data/hipxray.py:58-80``), so with
``--device_preprocess 1`` its CLI's device stage takes normalized floats
for bytes: it divides them by 255, flips and rotates them a second time and
normalizes them again.  That fault is not copied.
"""

from __future__ import annotations

import math
import os

import numpy as np

from xfmamba_tpu_torch.data.chexpert import NA_VALUES, read_table
from xfmamba_tpu_torch.data.image import load_grayscale
from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples, staged_or
from xfmamba_tpu_torch.data.transforms import mura_eval_transform, mura_train_transform

REQUIRED = ("Image_no", "Admission_Date", "Fracture_Classification", "Final_Classification")


def _number(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def pandas_column(cells):
    """The values of one CSV column as pandas' ``read_csv`` types them:
    missing cells (`NA_VALUES`) are NaN; int if every cell is an integer,
    float if every present cell is a number, else the strings."""
    present = [c for c in cells if c.strip() not in NA_VALUES]
    numbers = [_number(c) for c in present]
    if present and all(n is not None for n in numbers):
        if len(present) == len(cells) and all(c.strip().lstrip("+-").isdigit() for c in present):
            return [int(c) for c in cells]
        return [_number(c) if c.strip() not in NA_VALUES else math.nan for c in cells]
    return [c if c.strip() not in NA_VALUES else math.nan for c in cells]


def _isnan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def build_samples(images_dir: str, csv_file: str):
    """Returns (samples [(ap, lateral, label_int)], label_mapping)."""
    rows = read_table(csv_file)
    header = list(rows[0]) if rows else []
    missing = [c for c in REQUIRED if c not in header]
    if missing:
        raise ValueError(f"CSV missing required columns: {missing}")
    numbers = pandas_column([r["Image_no"] for r in rows])
    fracture = pandas_column([r["Fracture_Classification"] for r in rows])
    final = pandas_column([r["Final_Classification"] for r in rows])
    keep = [i for i, f in enumerate(fracture) if _isnan(f) or str(f).lower() != "exclude"]
    unique = sorted({final[i] for i in keep if not _isnan(final[i])})
    mapping = {label: i for i, label in enumerate(unique)}
    samples = []
    for i in keep:
        num = str(numbers[i]).zfill(3)
        ap = os.path.join(images_dir, f"{num} AP.jpg")
        lat = os.path.join(images_dir, f"{num} Lateral.jpg")
        if not (os.path.exists(ap) and os.path.exists(lat)):
            continue
        if _isnan(final[i]):
            continue
        samples.append((ap, lat, np.int32(mapping[final[i]])))
    if not samples:
        raise RuntimeError("no valid AP/Lateral pairs found")
    return samples, mapping


def _load_pair(sample):
    p1, p2, label = sample
    return load_grayscale(p1), load_grayscale(p2), label


def create_data_loaders(images_dir, csv_file, config):
    """Train/val split by the config's ratio over a seeded shuffle (the
    reference's ``create_data_loader``, `:118-`): (train, val, mapping)."""
    samples, mapping = build_samples(images_dir, csv_file)
    rng = np.random.default_rng(config["seed"])
    idx = rng.permutation(len(samples))
    n_train = int(config.get("train_ratio", 0.85) * len(samples))
    size = tuple(config["image_size"])
    tt, et = staged_or(config, mura_train_transform(size), mura_eval_transform(size))
    nw = config.get("num_workers", 4)
    procs = bool(config.get("loader_processes"))

    def mk(ids, tf):
        return TwoViewSamples([samples[i] for i in ids], _load_pair, tf)

    train_loader = TwoViewLoader(mk(idx[:n_train], tt), config["batch_size"], shuffle=True,
                                 drop_last=True, num_workers=nw, seed=config["seed"],
                                 use_processes=procs)
    val_loader = TwoViewLoader(mk(idx[n_train:], et), config["batch_size"], shuffle=False,
                               num_workers=nw, seed=config["seed"], use_processes=procs)
    return train_loader, val_loader, mapping
