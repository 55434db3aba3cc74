"""MURA two-view dataset pipeline (port of ``xfmamba_tpu/data/mura.py``
with ``csv`` and lists in place of pandas, and numpy in place of sklearn).

Behaviour follows ``libs/dataset_mura_twoview.py`` of the reference:
- study -> image grouping from the official CSVs (image paths, then study
  labels; each with a header row, skipped);
- view pairing per study: one image is paired with itself, two are one
  pair, three or more give every unordered pair;
- rows whose label is not an integer are dropped (JAX's pandas reads a
  label column with an empty, "n/a" or "1.0" field as floats and then drops
  every row; the port drops only the rows whose label is not an integer);
- a patient-level stratified 92/8 train/val split seeded by the config,
  UNKNOWN patients forced into train; the official valid CSV is the test
  set.

Tables are lists of row tuples in `COLUMNS` order.  `patient_level_split`
reproduces JAX's ``sklearn.model_selection.train_test_split`` call draw for
draw (`stratified_shuffle_split`, `shuffle_split`), and the patient label
its pandas ``value_counts().idxmax()`` (the most frequent label, ties to the
one seen first).
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples, staged_or
from xfmamba_tpu_torch.data.image import load_grayscale
from xfmamba_tpu_torch.data.transforms import mura_eval_transform, mura_train_transform

BODY_PARTS = ("ELBOW", "FINGER", "FOREARM", "HAND", "HUMERUS", "SHOULDER", "WRIST")
COLUMNS = ("image_path1", "image_path2", "label", "study_path", "patient_id", "body_part")
UNKNOWN_PATIENT = "UNKNOWN_PATIENT"


def study_pairs(images: Sequence[str]) -> List[Tuple[str, str]]:
    """The reference's pairing policy (``dataset_mura_twoview.py:936-955``)."""
    images = sorted(images)
    n = len(images)
    if n == 1:
        return [(images[0], images[0])]
    return [(images[i], images[j]) for i in range(n) for j in range(i + 1, n)]


def _study_of(image_path: str) -> str:
    return os.path.dirname(image_path.rstrip("/"))


def _patient_of(path: str) -> str:
    for part in path.strip("/").split(os.sep):
        if part.lower().startswith("patient"):
            return part
    return UNKNOWN_PATIENT


def _body_part_of(path: str, parts=BODY_PARTS) -> str:
    low = path.lower()
    for p in parts:
        if p.lower() in low:
            return p
    return "UNKNOWN"


def _read_rows(path: str, width: int) -> List[List[str]]:
    """The rows after the header, first ``width`` fields, blank lines
    skipped, spaces after a delimiter dropped (pandas ``read_csv(header=0,
    skipinitialspace=True)``)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, skipinitialspace=True) if r and any(r)]
    return [(r + [""] * width)[:width] for r in rows[1:]]


def read_mura_tables(image_paths_csv: str, study_labels_csv: str,
                     root_dir: str) -> List[tuple]:
    """Join image paths to study labels: one row per (img1, img2) pair, in
    `COLUMNS` order, studies in the order their first image appears."""
    study_to_label: Dict[str, int] = {}
    for study, label in _read_rows(study_labels_csv, 2):
        if not label.strip().lstrip("-").isdigit():
            continue            # the reference's cleaning (:852-863)
        study_to_label[os.path.normpath(os.path.join(root_dir, study))] = int(label)
    study_to_images: Dict[str, List[str]] = {}
    for (p,) in _read_rows(image_paths_csv, 1):
        full = os.path.normpath(os.path.join(root_dir, p))
        study = _study_of(full)
        if study in study_to_label:
            study_to_images.setdefault(study, []).append(full)
    rows = []
    for study, images in study_to_images.items():
        label = study_to_label[study]
        patient = _patient_of(study)
        for img1, img2 in study_pairs(images):
            rows.append((img1, img2, label, study, patient, _body_part_of(img1)))
    return rows


def patient_labels(rows: Sequence[tuple]) -> List[Tuple[str, int]]:
    """(patient, label) over patients in sorted order; a patient's label is
    the most frequent of its rows', ties going to the label seen first."""
    counts: Dict[str, Dict[int, int]] = {}
    for r in rows:
        c = counts.setdefault(r[4], {})
        c[r[2]] = c.get(r[2], 0) + 1
    return [(p, max(c, key=c.get)) for p, c in sorted(counts.items())]


def _split_sizes(n_samples: int, test_size: float) -> Tuple[int, int]:
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train <= 0:
        raise ValueError(f"with {n_samples} patients and test_size={test_size} the train "
                         "split would be empty")
    return n_train, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """sklearn's ``_approximate_mode``: the floor of each class's share of
    ``n_draws``, topped up by largest remainder, ties drawn from ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_shuffle_split(y: Sequence[int], test_size: float, seed: int):
    """(train, test) positions as ``train_test_split(..., test_size,
    random_state=seed, shuffle=True, stratify=y)`` draws them
    (``StratifiedShuffleSplit``, one split).  Raises ``ValueError`` where it
    does: a class of one member, or fewer train or test slots than
    classes."""
    y = np.asarray(y)
    n_train, n_test = _split_sizes(len(y), test_size)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("the least populated class has only 1 member")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must be at least the "
                         f"number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def shuffle_split(n_samples: int, test_size: float, seed: int):
    """(train, test) positions as the unstratified ``train_test_split``
    draws them (``ShuffleSplit``, one split)."""
    n_train, n_test = _split_sizes(n_samples, test_size)
    perm = np.random.RandomState(seed).permutation(n_samples)
    return perm[n_test:n_test + n_train], perm[:n_test]


def patient_level_split(rows: Sequence[tuple], seed: int, test_size: float = 0.08):
    """Stratified 92/8 patient split; UNKNOWN patients go to train
    (``:979-1015``).  Returns (train rows, val rows), each in table order;
    val drops rows of an UNKNOWN body part."""
    patients = patient_labels(rows)
    train_ids = {p for p, _ in patients if p == UNKNOWN_PATIENT}
    rest = [(p, lab) for p, lab in patients if p != UNKNOWN_PATIENT]
    labels = [lab for _, lab in rest]
    tr = te = None
    if len(set(labels)) > 1:
        try:
            tr, te = stratified_shuffle_split(labels, test_size, seed)
        except ValueError:      # too few patients per class to stratify
            pass
    if tr is None:
        tr, te = shuffle_split(len(rest), test_size, seed)
    train_ids.update(rest[i][0] for i in tr)
    test_ids = {rest[i][0] for i in te}
    assert not (train_ids & test_ids), "patient overlap in split"
    train = [r for r in rows if r[4] in train_ids]
    val = [r for r in rows if r[4] in test_ids and r[5] != "UNKNOWN"]
    return train, val


def _load_pair(sample):
    p1, p2, label = sample
    return load_grayscale(p1), load_grayscale(p2), np.int32(label)


def create_data_loaders(train_image_paths_csv, train_study_labels_csv,
                        valid_image_paths_csv, valid_study_labels_csv,
                        config, body_part: Optional[str] = None):
    """(train_loader, val_loader, test_loader); test = the official valid
    CSV, optionally of one ``body_part`` (the per-part inference sweep)."""
    root = config["root_dir"]
    rows = read_mura_tables(train_image_paths_csv, train_study_labels_csv, root)
    train_rows, val_rows = patient_level_split(rows, seed=config["seed"])
    test_rows = read_mura_tables(valid_image_paths_csv, valid_study_labels_csv, root)
    if body_part is not None:
        test_rows = [r for r in test_rows if r[5] == body_part]

    def samples(rows_, tf):
        return TwoViewSamples([r[:3] for r in rows_], _load_pair, tf)

    size = tuple(config["image_size"])
    tt, et = staged_or(config, mura_train_transform(size), mura_eval_transform(size))
    nw = config.get("num_workers", 4)
    procs = bool(config.get("loader_processes"))
    train_loader = TwoViewLoader(samples(train_rows, tt), config["batch_size"], shuffle=True,
                                 drop_last=True, num_workers=nw, seed=config["seed"],
                                 use_processes=procs)
    val_loader = TwoViewLoader(samples(val_rows, et), config["batch_size"], shuffle=False,
                               num_workers=nw, seed=config["seed"], use_processes=procs)
    test_loader = TwoViewLoader(samples(test_rows, et),
                                config.get("eval_batch_size", config["batch_size"]),
                                shuffle=False, num_workers=nw, seed=config["seed"],
                                use_processes=procs)
    return train_loader, val_loader, test_loader
