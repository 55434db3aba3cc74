"""Deep mutual learning (port of ``xfmamba_tpu/train/mutual.py``; the
reference's ``libs/train_mutual_learning.py``).

K models train jointly: each model's loss is its cross-entropy (or BCE)
plus the mean over its peers of KL(softmax of the peer, detached ‖ softmax
of the model) (``train_mutual_learning.py:89-102``).  As in JAX, one
backward of the summed loss replaces the reference's K backwards: every
peer term is detached, so the gradient of the sum with respect to model
i's parameters is model i's own.  `MutualMeter` is ``Totoal_Meter``
(``libs/utils.py:14-46``), `save_best_roc_checkpoint` the full-state
best-ROC file (``train_mutual_learning.py:306-325``) in the JAX package's
npz layout.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables
from xfmamba_tpu_torch.checkpoint.io import optax_adam_state, save_npz
from xfmamba_tpu_torch.train.loop import (
    bce_with_logits_loss, cross_entropy_loss, set_lr, zero_missing_grads)


def kl_div_loss(log_q, p, reduction: str = "mean"):
    """torch ``nn.KLDivLoss`` on log-probabilities ``log_q`` and
    probabilities ``p``, in JAX's form: pointwise p·(log max(p, 1e-12) −
    log q); "mean" averages over every element (the torch default the
    reference relies on), "batchmean" divides the sum by the batch, "sum"
    sums, any other reduction returns the pointwise values."""
    pointwise = p * (torch.log(p.clamp(min=1e-12)) - log_q)
    if reduction == "mean":
        return pointwise.mean()
    if reduction == "batchmean":
        return pointwise.sum() / pointwise.shape[0]
    if reduction == "sum":
        return pointwise.sum()
    return pointwise


class MutualMeter:
    """``Totoal_Meter``: sums of the losses and correct predictions over an
    epoch, averaged per batch (losses) and per sample (accuracy)."""

    def __init__(self, n_batch: int, n_dataset: int):
        self.n_batch = n_batch
        self.n_dataset = n_dataset
        self.reset()

    def reset(self):
        self.ce_loss = 0.0
        self.kl_loss = 0.0
        self.loss = 0.0
        self.acc = 0.0
        self.auc = 0.0
        self.epoch = 0

    def update(self, ce_loss, kl_loss, loss, acc, epoch):
        self.ce_loss += float(ce_loss)
        self.kl_loss += float(kl_loss)
        self.loss += float(loss)
        self.acc += float(acc)
        self.epoch = epoch

    def update_auc(self, auc):
        self.auc = float(auc)

    def get_avg(self) -> Dict[str, float]:
        return {
            "ce_loss": self.ce_loss / self.n_batch,
            "kl_loss": self.kl_loss / self.n_batch,
            "loss": self.loss / self.n_batch,
            "acc": self.acc / self.n_dataset,
            "auc": self.auc,
            "epoch": self.epoch,
        }


def make_mutual_train_step(models: Sequence, optimizers: Sequence, multilabel: bool = False,
                           two_view: Optional[Sequence[bool]] = None):
    """The mutual step over K models: ``step(batch, lr=None, reduce=None)`` puts every
    model in training mode, runs the K forwards (model i on both views when
    ``two_view[i]``, else on ``image1``), one backward of the summed loss,
    then the K optimizer steps (at ``lr`` when given); each model's
    BatchNorm statistics move as its own top moves them.  Returns, detached:
    ``loss`` (the total), ``ce_loss`` and ``kl_loss`` (K,) and ``logits``
    (a list of K).  The parameters' ``.grad`` keep the step's gradients.
    ``reduce``: a data-parallel step's gradient reduction (as in
    `train.loop.make_train_step`): every model's gradients averaged over the
    ranks before the K updates, the losses returned the global means."""
    K = len(models)
    if K < 2:
        raise ValueError("mutual learning needs at least two models")
    two_view = list(two_view) if two_view is not None else [True] * K
    ce_fn = bce_with_logits_loss if multilabel else cross_entropy_loss

    def step(batch, lr: Optional[float] = None, reduce=None):
        logits = []
        for model, opt, tv in zip(models, optimizers, two_view):
            model.train()
            if lr is not None:
                set_lr(opt, lr)
            opt.zero_grad(set_to_none=True)
            views = (batch["image1"], batch["image2"]) if tv else (batch["image1"],)
            logits.append(model(*views).float())
        log_q = [F.log_softmax(z, dim=1) for z in logits]
        p = [F.softmax(z.detach(), dim=1) for z in logits]
        ces = [ce_fn(z, batch["label"]) for z in logits]
        kls = [sum(kl_div_loss(log_q[i], p[j]) for j in range(K) if j != i) / (K - 1)
               for i in range(K)]
        total = sum(ce + kl for ce, kl in zip(ces, kls))
        total.backward()
        for opt in optimizers:
            zero_missing_grads(opt)
        losses = torch.cat([total.detach()[None], torch.stack(ces).detach(),
                            torch.stack(kls).detach()])
        if reduce is not None:
            reduce.mean_([p.grad for opt in optimizers for group in opt.param_groups
                          for p in group["params"]])
            losses = reduce.mean(losses)
        for opt in optimizers:
            opt.step()
        return {"loss": losses[0], "ce_loss": losses[1:K + 1], "kl_loss": losses[K + 1:],
                "logits": [z.detach() for z in logits]}

    return step


def save_best_roc_checkpoint(save_model_path: str, model_name: str, model, optimizer,
                             epoch: int, val_roc: float) -> str:
    """``{save_model_path}/{model_name}/best_model_{epoch}.npz`` with
    ``epoch`` (int32), ``val_roc`` (float32), ``params``, ``batch_stats``
    and ``opt_state``, each under the keys and in the layout that the JAX
    package's ``save_best_roc_checkpoint`` writes for the same state (the
    optimizer's state as optax's, `checkpoint.io.optax_adam_state`), so
    JAX's ``load_npz`` reads the same tree.  Returns the path."""
    model_dir = os.path.join(save_model_path, model_name)
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"best_model_{epoch}.npz")
    variables = export_jax_variables(model)
    save_npz(path, {"epoch": np.int32(epoch), "val_roc": np.float32(val_roc),
                    "params": variables["params"],
                    "batch_stats": variables.get("batch_stats", {}),
                    "opt_state": optax_adam_state(model, optimizer)})
    return path
