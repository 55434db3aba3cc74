"""CheXpert two-view (frontal + lateral) dataset pipeline (port of
``xfmamba_tpu/data/chexpert.py`` with ``csv`` and lists in place of pandas).

Behaviour follows ``libs/dataset_chexpert_twoview.py`` of the reference:
- the 14-label tuple (`:12-17`); the paper's 13-class protocol is
  ``drop_no_finding=True``;
- an os.walk map of image paths over the root folders (`:52-71`); CSV
  paths normalised to ``patientXXXX/...`` (`:115-121`), backslashes too;
- studies grouped by (patient, study), keeping those with both a frontal
  and a lateral view, the first row of each (`:139-152`);
- empty labels -> 0.0, -1 kept (`:163-167`);
- the 75/12.5/12.5 split of a seeded ``torch.randperm`` (`:311-320`).

What JAX's pandas does and this module does by hand: ``groupby`` visits
the (patient, study) keys in sorted order and drops a row whose path has
no second part (a NaN key); a label cell that pandas reads as missing (an
empty cell or one of its NA strings) or a missing label column gives 0.0;
``Frontal/Lateral`` is derived from the file name when the column is
absent; rows keep their CSV order within a study.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from xfmamba_tpu_torch.data.image import load_grayscale
from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples, staged_or
from xfmamba_tpu_torch.data.transforms import chexpert_eval_transform, chexpert_train_transform

LABELS = (
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
    "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture",
    "Support Devices", "No Finding",
)
# the strings pandas' read_csv takes for a missing value (its default na_values)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _normalize_path(path: str) -> str:
    parts = path.replace("\\", "/").split("/")
    for i, p in enumerate(parts):
        if p.startswith("patient"):
            return "/".join(parts[i:])
    return path


def _view_from_path(path: str) -> str:
    name = os.path.basename(path).lower()
    if "frontal" in name:
        return "Frontal"
    if "lateral" in name:
        return "Lateral"
    return "Unknown"


def build_image_path_map(root_dirs: Sequence[str]) -> Dict[str, str]:
    """normalised relative path -> absolute path (the reference's os.walk map)."""
    out = {}
    for root in root_dirs:
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.lower().endswith((".jpg", ".jpeg", ".png")):
                    full = os.path.join(dirpath, f)
                    out[_normalize_path(os.path.relpath(full, root))] = full
    return out


def _label(value) -> float:
    """A label cell as JAX's ``float(row.get(l)) if pd.notnull(...) else 0.0``
    reads it: missing -> 0.0, else its number."""
    if value is None or value.strip() in NA_VALUES:
        return 0.0
    return float(value)


def read_table(csv_file: str) -> List[Dict[str, str]]:
    """The CSV's rows as dicts by header name, blank lines skipped (pandas
    ``read_csv`` with its defaults); a short row's missing cells are
    empty."""
    with open(csv_file, newline="") as f:
        rows = [r for r in csv.reader(f) if r and any(r)]
    header = rows[0]
    return [dict(zip(header, r + [""] * (len(header) - len(r)))) for r in rows[1:]]


def build_samples(csv_files: Sequence[str], root_dirs: Sequence[str],
                  drop_no_finding: bool = False) -> List[Tuple]:
    """Returns [(frontal_path, lateral_path, label_vec float32)]."""
    labels = [l for l in LABELS if not (drop_no_finding and l == "No Finding")]
    path_map = build_image_path_map(root_dirs)
    samples = []
    for csv_file in ([csv_files] if isinstance(csv_files, str) else csv_files):
        groups: Dict[Tuple[str, str], List[Dict]] = {}
        for row in read_table(csv_file):
            path = _normalize_path(row["Path"])
            parts = path.split("/")
            if len(parts) < 2:
                continue                    # a NaN study id: groupby drops the row
            view = row["Frontal/Lateral"] if "Frontal/Lateral" in row else _view_from_path(path)
            groups.setdefault((parts[0], parts[1]), []).append(dict(row, Path=path, view=view))
        for key in sorted(groups):
            group = groups[key]
            fr = [r for r in group if r["view"] == "Frontal"]
            la = [r for r in group if r["view"] == "Lateral"]
            if not fr or not la:
                continue
            fp, lp = path_map.get(fr[0]["Path"]), path_map.get(la[0]["Path"])
            if fp is None or lp is None:
                continue
            vec = np.array([_label(fr[0].get(l)) for l in labels], np.float32)
            samples.append((fp, lp, vec))
    return samples


def reference_split_indices(n: int, seed: int):
    """The reference's torch.random_split membership (`:311-320`)."""
    train_n = int(0.75 * n)
    val_n = int(0.125 * n)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
    return perm[:train_n], perm[train_n:train_n + val_n], perm[train_n + val_n:]


def _load_pair(sample):
    p1, p2, vec = sample
    return load_grayscale(p1), load_grayscale(p2), vec


def create_train_val_test_data_loaders(train_root_dirs, train_csv_file, config,
                                       drop_no_finding=False):
    """(train, val, test) loaders (``create_train_val_test_data_loader``,
    `:288-357`)."""
    samples = build_samples(train_csv_file, train_root_dirs, drop_no_finding=drop_no_finding)
    tr_i, va_i, te_i = reference_split_indices(len(samples), config["seed"])
    size = tuple(config["image_size"])
    tt, et = staged_or(config, chexpert_train_transform(size), chexpert_eval_transform(size))
    nw = config.get("num_workers", 4)
    procs = bool(config.get("loader_processes"))

    def mk(idxs, tf):
        return TwoViewSamples([samples[i] for i in idxs], _load_pair, tf)

    train_loader = TwoViewLoader(mk(tr_i, tt), config["batch_size"], shuffle=True,
                                 drop_last=True, num_workers=nw, seed=config["seed"],
                                 use_processes=procs)
    val_loader = TwoViewLoader(mk(va_i, et), config["batch_size"], shuffle=False,
                               num_workers=nw, seed=config["seed"], use_processes=procs)
    test_loader = TwoViewLoader(mk(te_i, et), config.get("eval_batch_size", config["batch_size"]),
                                shuffle=False, num_workers=nw, seed=config["seed"],
                                use_processes=procs)
    return train_loader, val_loader, test_loader
