"""Typed training configuration (a copy of ``xfmamba_tpu/train/config.py``:
the port imports nothing of the JAX package).

One dataclass replaces the reference's argparse + plain-dict combo
(``libs/config.py:4-33`` and ``1_train_model.py:29-55``), keeping every
reference flag as a field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # data (reference defaults: libs/config.py)
    dataset: str = "mura"            # mura | chexpert | ddsmxray | hipxray
    data_root: str = ""
    image_size: Tuple[int, int] = (224, 224)
    train_ratio: float = 0.85
    valid_ratio: float = 0.15
    batch_size: int = 16
    eval_batch_size: int = 16
    num_workers: int = 4
    seed: int = 42

    # model (1_train_model.py:29-55)
    model_name: str = "twoviewxfmamba"   # + _tiny/_base, singleview, latejoin, earlyfusion
    num_tasks: int = 1
    num_classes: int = 2
    view_num: int = 2
    view_sel: int = 0
    pretrained_model_path: Optional[str] = None
    savemodel_path: str = "runs"

    # optimization (1_train_model.py:141-147, libs/utils.py:83-134)
    optimizer: str = "adam"          # adam | sgd | adamw
    lr: float = 1e-4
    weight_decay: float = 1e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.9
    scheduler: str = "step"          # step | cos | reduce | none
    step_size: int = 10
    gamma: float = 0.1
    epochs: int = 100
    patience: int = 100

    # precision / execution
    compute_dtype: str = "float32"   # float32 | bfloat16
    use_checkpoint: bool = False     # activation remat
    data_parallel: bool = True

    # logging
    wandb: bool = False
    log_every: int = 50
