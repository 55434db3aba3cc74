"""Deep-mutual-learning CLI (port of ``xfmamba_tpu/cli/train_mutual.py``;
the reference's ``libs/train_mutual_learning.py``, whose own ``train()``
is commented out, argparse at :14-43).  Every flag of the JAX CLI, plus
``--device`` (default ``cuda``).

K models train jointly (`train.mutual.make_mutual_train_step`: CE plus the
mean KL against the detached peers, one backward of the summed loss).
Each epoch prints, per model, the mean CE and KL over the batches and the
ROC AUC of the epoch's *training* logits, and writes
``{savemodel_path}/{name}/best_model_{epoch}.npz`` when that AUC is the
model's best so far.  Both are the JAX CLI's behaviour, kept: it runs no
validation pass (the validation split is built and never read), so the
"best ROC" is the training AUC.  Each epoch also prints the median ms per
mutual step (CUDA events on the card).

Every dataset of ``cli.train`` (its ``build_loaders``).  CheXpert trains
multilabel, as ``fit`` does (``--num_tasks`` above 1 or ``--dataset
chexpert``), with ``fit``'s accuracy of the labels at sigmoid > 0.5; JAX's
mutual CLI looks at ``--num_tasks`` alone and takes an argmax accuracy,
which fails on multilabel batches.  One device
only: ``--coordinator_address``, ``--num_processes`` above 1 and more than
one visible CUDA device raise ``NotImplementedError`` (the JAX CLI shards
the batch over a mesh; the port has no data parallelism yet).

Usage (the default pair, XFMamba-T and XFMamba-S, on MURA):
    python -m xfmamba_tpu_torch.cli.train_mutual --dataset mura \\
        --model_names twoviewxfmamba_tiny twoviewxfmamba \\
        --data_root ... --train_image_csv ... --train_label_csv ... \\
        --valid_image_csv ... --valid_label_csv ... --savemodel_path runs/dml
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from xfmamba_tpu_torch.cli import build_model_by_name
from xfmamba_tpu_torch.cli.train import build_loaders
from xfmamba_tpu_torch.train.config import TrainConfig
from xfmamba_tpu_torch.train.driver import DDP_ITEM


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="XFMamba mutual learning (PyTorch, CUDA)")
    # reference flags (train_mutual_learning.py:14-43)
    p.add_argument("--dataset", default="mura",
                   choices=["mura", "chexpert", "ddsmxray", "hipxray"])
    p.add_argument("--model_names", nargs="+",
                   default=["twoviewxfmamba_tiny", "twoviewxfmamba"])
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--num_tasks", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=16,
                   help="GLOBAL batch size (split across hosts and devices)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--savemodel_path", default="runs/mutual")
    p.add_argument("--bf16", type=int, default=0)
    # data paths (as cli.train)
    p.add_argument("--data_root", default="")
    p.add_argument("--train_image_csv", default=None)
    p.add_argument("--train_label_csv", default=None)
    p.add_argument("--valid_image_csv", default=None)
    p.add_argument("--valid_label_csv", default=None)
    p.add_argument("--chexpert_csv", default=None)
    p.add_argument("--ddsm_metadata_csv", default=None)
    p.add_argument("--ddsm_case_csvs", nargs="*", default=None)
    p.add_argument("--hip_images_dir", default=None)
    p.add_argument("--hip_csv", default=None)
    p.add_argument("--num_workers", type=int, default=4)
    # multi-host bootstrap: not ported (raises)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _check_one_device(args):
    if args.coordinator_address or (args.num_processes or 1) > 1:
        raise NotImplementedError(f"multi-process mutual learning is not ported ({DDP_ITEM})")
    if torch.device(args.device).type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"mutual learning over {torch.cuda.device_count()} CUDA devices is not ported "
            f"({DDP_ITEM}); make one device visible")


def _auc(logits: np.ndarray, labels: np.ndarray, multilabel: bool) -> float:
    """The JAX CLI's AUC of an epoch's logits (NaN where it cannot be
    computed, as for one class)."""
    from xfmamba_tpu_torch.train import metrics as M
    try:
        if multilabel:
            return M.multilabel_mean_auc(labels, 1.0 / (1.0 + np.exp(-logits)))
        e = np.exp(logits - logits.max(1, keepdims=True))
        return M.roc_auc(labels, (e / e.sum(1, keepdims=True))[:, 1])
    except Exception:
        return float("nan")


def main(argv=None):
    """Returns (models, history): per epoch ``{"epoch", "models": [each
    model's `MutualMeter` averages], "step_ms", "checkpoints": [paths
    written]}``."""
    args = parse_args(argv)
    _check_one_device(args)
    from xfmamba_tpu_torch.train.driver import _to_device
    from xfmamba_tpu_torch.train.loop import make_optimizer
    from xfmamba_tpu_torch.train.mutual import (
        MutualMeter, make_mutual_train_step, save_best_roc_checkpoint)

    cfg = TrainConfig(
        dataset=args.dataset, data_root=args.data_root,
        image_size=(args.image_size, args.image_size),
        batch_size=args.batch_size, eval_batch_size=args.batch_size,
        num_workers=args.num_workers, seed=args.seed,
        num_classes=args.num_classes, num_tasks=args.num_tasks,
        lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
        savemodel_path=args.savemodel_path,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["root_dir"] = cfg.data_root
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    multilabel = cfg.num_tasks > 1 or cfg.dataset == "chexpert"

    train_loader, _, _ = build_loaders(args, cfg_dict)
    train_loader.drop_last = True
    # each model its own seeds (JAX folds the model's index into its key)
    models, two_view = [], []
    for i, name in enumerate(args.model_names):
        model, tv = build_model_by_name(name, cfg.num_classes, device=args.device,
                                        seed=cfg.seed + 2 * i)
        models.append(model)
        two_view.append(tv)
    K = len(models)
    optimizers = [make_optimizer(cfg, m.parameters()) for m in models]
    step = make_mutual_train_step(models, optimizers, multilabel=multilabel,
                                  two_view=two_view)
    device = next(models[0].parameters()).device
    cuda = device.type == "cuda"

    os.makedirs(cfg.savemodel_path, exist_ok=True)
    best_roc = [-np.inf] * K
    history = []
    for epoch in range(cfg.epochs):
        outs, labels, events, walls = [], [], [], []
        for batch in train_loader:
            dev = _to_device(batch, device, dtype, multilabel)
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                outs.append(step(dev, cfg.lr))
                end.record()
                events.append((start, end))
            else:
                t0 = time.perf_counter()
                outs.append(step(dev, cfg.lr))
                walls.append(1e3 * (time.perf_counter() - t0))
            labels.append(np.asarray(batch["label"]))
        # one fetch an epoch: the steps' losses and logits stay on the device
        ce = torch.stack([o["ce_loss"] for o in outs]).cpu().numpy()
        kl = torch.stack([o["kl_loss"] for o in outs]).cpu().numpy()
        total = torch.stack([o["loss"] for o in outs]).float().cpu().numpy()
        logits = [[o["logits"][i].cpu().numpy() for o in outs] for i in range(K)]
        step_ms = [s.elapsed_time(e) for s, e in events] if cuda else walls
        meters = [MutualMeter(max(len(train_loader), 1),
                              max(len(train_loader) * cfg.batch_size, 1)) for _ in range(K)]
        checkpoints = []
        for i in range(K):
            for s, lab in enumerate(labels):
                if multilabel:
                    # each sample's share of labels right at sigmoid > 0.5, as fit's accuracy
                    acc = ((logits[i][s] > 0) == (lab > 0.5)).mean(1).sum()
                else:
                    acc = (logits[i][s].argmax(1) == lab).sum()
                meters[i].update(ce[s, i], kl[s, i], total[s] / K, acc, epoch)
            if labels:
                meters[i].update_auc(_auc(np.concatenate(logits[i]), np.concatenate(labels),
                                          multilabel))
            avg = meters[i].get_avg()
            print(f"epoch {epoch} model[{i}] {args.model_names[i]}: ce={avg['ce_loss']:.4f} "
                  f"kl={avg['kl_loss']:.4f} auc={avg['auc']:.4f}")
            if avg["auc"] == avg["auc"] and avg["auc"] > best_roc[i]:
                best_roc[i] = avg["auc"]
                checkpoints.append(save_best_roc_checkpoint(
                    cfg.savemodel_path, args.model_names[i], models[i], optimizers[i], epoch,
                    avg["auc"]))
        if step_ms:
            print(f"epoch {epoch}: {len(step_ms)} mutual steps, median "
                  f"{statistics.median(step_ms):.2f} ms per step "
                  f"({'CUDA events' if cuda else 'host clock'})")
        history.append({"epoch": epoch, "models": [m.get_avg() for m in meters],
                        "step_ms": step_ms, "checkpoints": checkpoints})
    return models, history


if __name__ == "__main__":
    main()
