"""Train and eval steps, optimizers, schedules and losses (port of
``xfmamba_tpu/train/loop.py``).

PyTorch trains eagerly: the model holds its parameters and batch
statistics, and `make_train_step` returns a step that runs forward,
backward and one optimizer update in place.  `EarlyStopping` is here, as
in the JAX package; the epoch loop is ``train/driver.py::fit``.

Optimizer semantics follow the JAX package (``libs/utils.py:83-134`` of the
reference): torch ``Adam(weight_decay=...)`` adds the L2 term to the
gradient before the moments, as optax ``add_decayed_weights`` before
``scale_by_adam`` does; ``adamw`` decays decoupled; ``sgd`` is momentum SGD
with L2.  The learning rate is set on ``param_groups`` (`set_lr`), so the
host can drive any schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.models.layers import global_rows, to_device
from xfmamba_tpu_torch.train.config import TrainConfig


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Per-epoch learning rate; ``reduce`` (on plateau) is the epoch
    loop's and reads as a constant here."""
    if cfg.scheduler == "step":
        return lambda epoch: cfg.lr * (cfg.gamma ** (epoch // cfg.step_size))
    if cfg.scheduler == "cos":
        return lambda epoch: 0.5 * cfg.lr * (1 + math.cos(math.pi * epoch / max(cfg.epochs, 1)))
    return lambda epoch: cfg.lr


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """adam / adamw / sgd over ``params`` with torch's weight-decay
    semantics (see the module docstring)."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas),
                                weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=tuple(cfg.betas),
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def cross_entropy_loss(logits, labels, reduction: str = "mean"):
    """Mean cross-entropy with integer labels (``1_train_model.py:134-135``)."""
    return F.cross_entropy(logits.float(), labels, reduction=reduction)


def bce_with_logits_loss(logits, labels, reduction: str = "mean"):
    """Mean multi-label BCE on logits (``1_train_model.py:136-137``)."""
    return F.binary_cross_entropy_with_logits(logits.float(), labels.float(),
                                              reduction=reduction)


def zero_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A parameter off the loss's graph (the backbone's out-norms 0-2) gets
    a zero gradient, so that weight decay and the moments move it as optax
    moves every leaf; torch would skip it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_train_step(model, optimizer, multilabel: bool, two_view: bool = True,
                    preprocess=None, dtype: torch.dtype = torch.float32):
    """(train_step, eval_step) for a batch dict with ``image1`` (and
    ``image2``) and ``label``.

    ``train_step(batch, lr=None, reduce=None)`` puts the model in training
    mode, runs forward, backward and one optimizer step (at ``lr`` when
    given) and returns ``{"loss", "logits"}``, detached; the parameters'
    ``.grad`` keep the step's gradients.  ``reduce``: the gradient
    reduction of a data-parallel step (a `parallel.mesh.Mesh`, which
    `parallel.mesh.make_parallel_train_step` passes): the gradients are
    averaged over the ranks after `zero_missing_grads` and before the
    update, and the loss returned is the global mean.

    ``eval_step(batch)`` runs in eval mode without gradients and returns,
    for the batch's ``n_valid`` rows (all rows where it has no
    ``n_valid``; the rest are padding): ``logits``, ``label``, ``loss`` (the
    mean), ``loss_sum`` and ``count`` (the loss's terms).

    ``preprocess``: a `data.device_pipeline.DevicePreprocess`; the views
    then arrive as staged uint8 (B, Hs, Ws, 1) on the model's device, and
    the stage's kernel makes them float (one launch a view), in ``dtype``
    for the model.  A train step draws both views' augmentation rows from
    ``preprocess.generator`` before its first launch and copies them to
    the device in one copy.  An eval step takes the stage's ``eval_batch``."""
    loss_fn = bce_with_logits_loss if multilabel else cross_entropy_loss

    def inputs(batch, rows=None):
        views = (batch["image1"], batch["image2"]) if two_view else (batch["image1"],)
        if preprocess is None:
            return views
        if rows is None:
            return tuple(preprocess.eval_batch(v).to(dtype) for v in views)
        return tuple(preprocess.train_batch(v, r).to(dtype) for v, r in zip(views, rows))

    def augment_rows(batch):
        B = batch["image1"].shape[0]
        rows = torch.stack([preprocess.rows(global_rows(preprocess.draw_params, B))
                            for _ in range(2 if two_view else 1)])
        return to_device(rows, batch["image1"].device)

    def train_step(batch, lr: Optional[float] = None, reduce=None):
        rows = None if preprocess is None else augment_rows(batch)
        model.train()
        if lr is not None:
            set_lr(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        logits = model(*inputs(batch, rows))
        loss = loss_fn(logits, batch["label"])
        loss.backward()
        zero_missing_grads(optimizer)
        loss = loss.detach()
        if reduce is not None:
            reduce.mean_([p.grad for group in optimizer.param_groups for p in group["params"]])
            loss = reduce.mean(loss)
        optimizer.step()
        return {"loss": loss, "logits": logits.detach()}

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        nv = int(batch.get("n_valid", batch["label"].shape[0]))
        logits = model(*inputs(batch))[:nv]
        label = batch["label"][:nv]
        loss_sum = loss_fn(logits, label, reduction="sum")
        return {"loss": loss_sum / max(label.numel(), 1), "loss_sum": loss_sum,
                "count": label.numel(), "logits": logits, "label": label}

    return train_step, eval_step


def mixup(x, y, generator: torch.Generator, alpha: float = 1.0,
          num_classes: Optional[int] = None, lam=None, perm=None):
    """Mixup (``libs/utils.py:177-191``): a convex combination of a batch
    with a shuffled copy of itself.  λ ~ Beta(alpha, alpha) (1 when alpha
    <= 0) and the permutation come from ``generator`` unless given.
    Integer labels are one-hot encoded first (pass ``num_classes``).
    Returns (mixed_x, mixed_y, lam)."""
    if lam is None:
        if alpha > 0:
            seed = int(torch.randint(2 ** 62, (), generator=generator))
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                lam = float(torch.distributions.Beta(alpha, alpha).sample())
        else:
            lam = 1.0
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=generator).to(x.device)
    mixed_x = lam * x + (1 - lam) * x[perm]
    if num_classes is not None and y.dim() == 1:
        y = F.one_hot(y, num_classes).to(x.dtype)
    mixed_y = lam * y + (1 - lam) * y[perm]
    return mixed_x, mixed_y, lam


class EarlyStopping:
    """Patience on -val_loss with best-checkpoint tracking (``early_stop.py:
    4-51``).  The reference saves a checkpoint every epoch whether or not
    the loss improved; ``save_every_epoch`` keeps that as the default.
    ``save_fn(state, epoch, improved)`` is called on every save.  The
    counters are plain attributes (`state_dict` / `load_state_dict`), so a
    resumed run stops where the uninterrupted one would."""

    FIELDS = ("counter", "best_score", "early_stop", "best_epoch")

    def __init__(self, patience: int = 100, delta: float = 0.0,
                 save_fn: Optional[Callable] = None, save_every_epoch: bool = True):
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.save_fn = save_fn
        self.save_every_epoch = save_every_epoch
        self.best_epoch = -1

    def __call__(self, val_loss: float, state, epoch: int):
        score = -val_loss
        improved = self.best_score is None or score > self.best_score + self.delta
        if improved:
            self.best_score = score
            self.best_epoch = epoch
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        if self.save_fn is not None and (improved or self.save_every_epoch):
            self.save_fn(state, epoch, improved)
        return self.early_stop

    def state_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}

    def load_state_dict(self, state: dict) -> None:
        for name in self.FIELDS:
            setattr(self, name, state[name])
