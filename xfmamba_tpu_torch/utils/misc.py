"""Misc training utilities (a copy of ``xfmamba_tpu/utils/misc.py``; the
reference's ``libs/utils.py`` and ``libs/training.py:11-18``)."""

from __future__ import annotations

import datetime
import os
import random
from typing import Dict, Optional

import numpy as np
import torch


def set_random_seeds(seed: int = 42) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators
    (``libs/training.py:11-18``, ``libs/utils.py:71-80``) and return a
    ``torch.Generator`` seeded with ``seed``; the port's code draws from
    explicit generators like this one, not from the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def show_config(config: Dict, log_fn=print):
    """Pretty-print a config dict (`libs/utils.py:48-56`)."""
    log_fn("Configurations:")
    log_fn("-" * 70)
    log_fn(f"|{'keys':>25} | {'values':<40}|")
    log_fn("-" * 70)
    for k, v in config.items():
        log_fn(f"|{str(k):>25} | {str(v):<40}|")
    log_fn("-" * 70)


def get_save_path(base_dir: str = "runs", model_name: str = "model",
                  dataset: str = "", tag: Optional[str] = None) -> str:
    """Timestamped run directory (`libs/utils.py:137-160`):
    ``{base}/{dataset}_{model}_{YYYYmmdd-HHMMSS}[_{tag}]``."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    parts = [p for p in (dataset, model_name, stamp, tag) if p]
    path = os.path.join(base_dir, "_".join(parts))
    os.makedirs(path, exist_ok=True)
    return path
