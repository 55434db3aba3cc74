"""The epoch driver (port of ``xfmamba_tpu/train/driver.py``): the
reference's ``train_one_epoch`` / ``validator`` (``libs/training.py:138-330``)
and the ``1_train_model.py`` epoch loop (:158-187).

Losses and logits stay on the device during an epoch and are fetched once
at its end.  Batches arrive as numpy from the loader and go to the model's
device here, the views in the config's compute dtype, or as staged uint8
for a device stage (``fit(..., preprocess=...)``), whose kernel makes them
float on the card.  Per epoch, `fit`
writes ``model_epoch_{n}.npz`` (every epoch, as the reference does),
``best.npz`` when the val loss improved (both in the JAX layout, through
`checkpoint.convert.export_jax_variables`), ``epoch_{n}/metrics.txt`` and the full
training state ``last.pt``; ``fit(..., init_state=load_state(last.pt))``
resumes from it.

Four faults of the JAX driver are not copied:
- ``fit`` takes the model's ``two_view``, so a single-view model trains and
  is evaluated on ``image1`` alone; JAX initialises with both views and
  never passes ``two_view`` to its steps, so its single-view model binds
  the second view to ``deterministic``;
- the "reduce" schedule is the reference's ``ReduceLROnPlateau(mode="min",
  factor=0.1, patience=10)``; JAX compares the epoch's loss with a minimum
  that includes it, and so decays every 11 epochs whatever the loss does;
- the eval loss is the mean over the valid rows; JAX averages the zero
  pad rows of a short last batch into it;
- ``last.pt`` holds the optimizer, the epoch and the generators, so a run
  resumes; JAX's ``fit`` checkpoints hold the weights only.

Data parallelism (``cfg.data_parallel``, JAX's mesh over the local
devices): in a process group (`parallel.distributed.ensure_initialized`),
one process a card, each rank loads its slice of every global batch and
runs `parallel.mesh`'s steps, so W ranks compute what one computes on the
global batch; the epoch metrics come from the gathered logits, and only
rank 0 logs and writes files.  `cli.train` starts the ranks.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from xfmamba_tpu_torch.checkpoint import io as ckpt
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables
from xfmamba_tpu_torch.train import metrics as M
from xfmamba_tpu_torch.train.config import TrainConfig
from xfmamba_tpu_torch.train.loop import (
    EarlyStopping, lr_schedule, make_optimizer, make_train_step)


def _to_device(batch: Dict, device, dtype, multilabel: bool) -> Dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device=device, dtype=dtype)
           for k in ("image1", "image2") if k in batch}
    label = torch.from_numpy(np.asarray(batch["label"]))
    out["label"] = label.to(device=device, dtype=torch.float32 if multilabel else torch.long)
    return out


def run_train_epoch(train_step, loader, lr, multilabel: bool, device, dtype=torch.float32,
                    log_every: int = 50, log_fn: Callable = print, mesh=None):
    """One epoch; returns its stats: the metrics of `compute_epoch_metrics`
    on the epoch's logits (with a `parallel.mesh.Mesh`, every rank's,
    gathered as one rank would hold them), the mean train loss, ``time_s``,
    ``loader_wait_s`` (the host's wait for batches), ``first_batch_wait_s``
    (the part of it before the first batch: the pool's start and the first
    fill), ``steps`` and, on CUDA, ``step_ms`` (each step by CUDA events)."""
    losses, all_logits, all_labels, events, waits = [], [], [], [], []
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    batches = iter(loader)
    while True:
        tw = time.perf_counter()
        batch = next(batches, None)
        waits.append(time.perf_counter() - tw)
        if batch is None:
            break
        dev = _to_device(batch, device, dtype, multilabel)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        out = train_step(dev, lr)
        if cuda:
            end.record()
            events.append((start, end))
        losses.append(out["loss"])
        all_logits.append(out["logits"])
        all_labels.append(np.asarray(batch["label"]))
        if log_every and len(losses) % log_every == 0:
            log_fn(f"  step {len(losses)}/{len(loader)} loss={float(out['loss']):.4f}")
    if not losses:
        raise ValueError("the train loader gave no batch (fewer samples than one batch, "
                         "whose remainder it drops)")
    logits, labels = torch.cat(all_logits).float(), np.concatenate(all_labels)
    if mesh is not None:
        logits = mesh.gather_steps(logits, len(losses))
        labels = mesh.gather_steps(torch.from_numpy(labels).to(logits.device),
                                   len(losses)).cpu().numpy()
    stats = compute_epoch_metrics(logits.cpu().numpy(), labels, multilabel)
    stats["loss"] = float(torch.stack(losses).double().mean())
    stats["steps"] = len(losses)
    if cuda:
        stats["step_ms"] = [s.elapsed_time(e) for s, e in events]
    stats["time_s"] = time.perf_counter() - t0
    stats["loader_wait_s"] = sum(waits)
    stats["first_batch_wait_s"] = waits[0]
    return stats


def run_eval_epoch(eval_step, loader, multilabel: bool, device, dtype=torch.float32,
                   mesh=None):
    """Validation or test pass over zero-padded batches; logits and the
    loss are those of each batch's ``n_valid`` rows only.  With a
    `parallel.mesh.Mesh` each rank runs its rows of every global batch
    (`parallel.mesh.make_parallel_eval_step`) and the pass is the global
    batches', as one rank gives it.  Returns (stats, logits, labels)."""
    if mesh is not None:
        from xfmamba_tpu_torch.parallel.mesh import make_parallel_eval_step
        eval_step = make_parallel_eval_step(eval_step, mesh)
    loss_sum, count = None, 0
    all_logits, all_labels = [], []
    for batch in loader:
        nv = int(batch.get("n_valid", batch["label"].shape[0]))
        dev = _to_device(batch, device, dtype, multilabel)
        if mesh is None:
            logits = eval_step(dev)["logits"][:nv].float()
            label = dev["label"][:nv]
            all_labels.append(np.asarray(batch["label"])[:nv])
        else:
            out = eval_step(dict(dev, n_valid=nv))
            logits, label = out["logits"], out["label"]
            all_labels.append(label.cpu().numpy())
        if multilabel:
            part = F.binary_cross_entropy_with_logits(logits, label, reduction="sum")
        else:
            part = F.cross_entropy(logits, label, reduction="sum")
        loss_sum = part if loss_sum is None else loss_sum + part
        count += label.numel()
        all_logits.append(logits)
    if not all_logits:
        raise ValueError("the eval loader gave no batch")
    logits = torch.cat(all_logits).cpu().numpy()
    labels = np.concatenate(all_labels)
    stats = compute_epoch_metrics(logits, labels, multilabel)
    stats["loss"] = float(loss_sum) / count
    return stats, logits, labels


def compute_epoch_metrics(logits: np.ndarray, labels: np.ndarray, multilabel: bool) -> Dict:
    """The reference's metrics: binary softmax[:, 1] ROC-AUC, accuracy and
    confusion statistics (``training.py:197-204``), or the sigmoid
    per-label mean AUC (:205-214).  The softmax is float32, as JAX's."""
    if multilabel:
        probs = 1.0 / (1.0 + np.exp(-logits))
        mean_auc, per = M.multilabel_mean_auc(labels, probs, return_per_label=True)
        preds = probs > 0.5
        acc = float((preds == (labels > 0.5)).mean())
        return {"auc": mean_auc, "per_label_auc": per, "accuracy": acc}
    x = np.asarray(logits, np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    scores = probs[:, 1] if probs.shape[1] == 2 else probs.max(axis=1)
    preds = probs.argmax(axis=1)
    out = {"accuracy": float((preds == labels).mean())}
    if probs.shape[1] == 2:
        out["auc"] = M.roc_auc(labels, scores)
        out.update(M.binary_confusion_stats(labels, preds))
    return out


def write_epoch_artifacts(out_dir: str, epoch: int, stats: Dict, logits=None, labels=None,
                          multilabel=False):
    """``epoch_{n}/metrics.txt`` and, with matplotlib, the confusion-matrix
    PNG (``plot_confusion_matrix``, ``training.py:20-134``)."""
    ep_dir = os.path.join(out_dir, f"epoch_{epoch}")
    os.makedirs(ep_dir, exist_ok=True)
    with open(os.path.join(ep_dir, "metrics.txt"), "w") as f:
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")
    if logits is not None and not multilabel and logits.shape[1] == 2:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            preds = logits.argmax(axis=1)
            cm = np.zeros((2, 2), int)
            for t, p in zip(labels, preds):
                cm[int(t), int(p)] += 1
            fig, ax = plt.subplots()
            ax.imshow(cm, cmap="Blues")
            for i in range(2):
                for j in range(2):
                    ax.text(j, i, str(cm[i, j]), ha="center", va="center")
            ax.set_xlabel("predicted")
            ax.set_ylabel("true")
            fig.savefig(os.path.join(ep_dir, "confusion_matrix.png"))
            plt.close(fig)
        except Exception:
            pass


def _log_wandb(epoch, lr, tr, va):
    try:
        import wandb as _wandb
        if _wandb.run is not None:
            _wandb.log({"epoch": epoch, "lr": lr, "train_loss": tr["loss"],
                        "train_acc": tr.get("accuracy"), "train_auc": tr.get("auc"),
                        "val_loss": va["loss"], "val_acc": va.get("accuracy"),
                        "val_auc": va.get("auc")})
    except Exception:
        pass


def fit(model, cfg: TrainConfig, train_loader, val_loader, init_state: Optional[dict] = None,
        log_fn: Callable = print, out_dir: Optional[str] = None, save_checkpoints: bool = True,
        two_view: bool = True, preprocess=None):
    """Train ``model`` (on its device) for ``cfg.epochs`` epochs with early
    stopping and the configured schedule; returns (state, history), the
    state being what ``last.pt`` holds after the last epoch.  ``two_view``
    (from `cli.build_model_by_name`): the model takes both views, else
    ``image1`` alone, in training and in evaluation.

    ``init_state``: a state of `checkpoint.io.training_state` (``last.pt``)
    to resume from, at the epoch after its own.  The views go to the
    model in ``cfg.compute_dtype``.  ``preprocess``: a
    `data.device_pipeline.DevicePreprocess` (the loaders then stage uint8,
    ``device_preprocess`` in their config); ``last.pt`` keeps its
    generator.

    ``cfg.data_parallel`` in a process group of W ranks (each calls
    ``fit`` with the model on its card): the global ``batch_size`` and
    ``eval_batch_size`` must divide by W; the loaders get this rank's
    ``process_slice``, the weights rank 0's, and the steps are
    `parallel.mesh`'s.  Every rank returns the same state; rank 0 alone logs
    and writes.  Without a process group the model's device trains alone."""
    multilabel = cfg.num_tasks > 1 or cfg.dataset == "chexpert"
    device = next(model.parameters()).device
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    mesh = None
    if cfg.data_parallel and dist.is_initialized():
        from xfmamba_tpu_torch.parallel.distributed import process_batch_slice
        from xfmamba_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device=device)
        for name, bs in (("batch_size", cfg.batch_size),
                         ("eval_batch_size", cfg.eval_batch_size)):
            if bs % mesh.world:
                raise ValueError(
                    f"data_parallel: {name}={bs} is not divisible by the {mesh.world} "
                    f"processes; adjust the batch size or pass data_parallel=False")
        train_loader.process_slice = process_batch_slice(train_loader.batch_size)
        val_loader.process_slice = process_batch_slice(val_loader.batch_size)
    primary = mesh is None or mesh.rank == 0
    if not primary:
        log_fn = lambda *args, **kw: None  # noqa: E731
    optimizer = make_optimizer(cfg, model.parameters())
    plateau = (torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer, mode="min", factor=0.1,
                                                          patience=10)
               if cfg.scheduler == "reduce" else None)
    train_step, eval_step = make_train_step(model, optimizer, multilabel, two_view,
                                            preprocess, dtype)
    if mesh is not None:
        from xfmamba_tpu_torch.parallel.mesh import make_parallel_train_step
        train_step = make_parallel_train_step(train_step, mesh)
        log_fn(f"data-parallel: batches split over {mesh.world} processes")
    views = torch.uint8 if preprocess is not None else dtype
    sched = lr_schedule(cfg)
    out_dir = out_dir or cfg.savemodel_path
    save_checkpoints = save_checkpoints and primary
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    seconds = {}

    def save_fn(m, epoch, improved):
        if save_checkpoints:
            t = time.perf_counter()
            variables = export_jax_variables(m)
            ckpt.save_npz(os.path.join(out_dir, f"model_epoch_{epoch}.npz"), variables)
            if improved:
                ckpt.save_npz(os.path.join(out_dir, "best.npz"), variables)
            seconds["npz_s"] = time.perf_counter() - t

    stopper = EarlyStopping(patience=cfg.patience, save_fn=save_fn)
    history, first = [], 0
    if init_state is not None:
        model.load_state_dict(init_state["model"])
        optimizer.load_state_dict(init_state["optimizer"])
        stopper.load_state_dict(init_state["early_stopping"])
        if plateau is not None:
            plateau.load_state_dict(init_state["plateau"])
        ckpt.restore_generators(model, init_state["generators"])
        train_loader._epoch = init_state["train_loader_epoch"]
        if preprocess is not None:
            if init_state.get("preprocess_generator") is None:
                raise ValueError("the checkpoint holds no device stage's generator")
            preprocess.generator.set_state(init_state["preprocess_generator"])
        history = list(init_state["history"])
        first = init_state["epoch"] + 1
        log_fn(f"resuming at epoch {first} (best epoch {stopper.best_epoch})")
    if mesh is not None:
        mesh.broadcast_([t.detach() for t in (*model.parameters(), *model.buffers())])
    state = None
    for epoch in range(first, cfg.epochs):
        if stopper.early_stop:
            break
        lr = sched(epoch) if plateau is None else optimizer.param_groups[0]["lr"]
        tr = run_train_epoch(train_step, train_loader, lr, multilabel, device, views,
                             log_every=cfg.log_every, log_fn=log_fn, mesh=mesh)
        t = time.perf_counter()
        va, logits, labels = run_eval_epoch(eval_step, val_loader, multilabel, device, views,
                                            mesh=mesh)
        eval_s = time.perf_counter() - t
        log_fn(f"epoch {epoch}: lr={lr:.2e} train_loss={tr['loss']:.4f} "
               f"val_loss={va['loss']:.4f} val_auc={va.get('auc', float('nan')):.4f} "
               f"({tr['time_s']:.2f} s train, {tr['loader_wait_s']:.2f} s of it waiting for "
               f"batches, {tr['first_batch_wait_s']:.2f} s for the first; {eval_s:.2f} s eval)")
        if getattr(cfg, "wandb", False) and primary:
            _log_wandb(epoch, lr, tr, va)
        t = time.perf_counter()
        if primary:
            write_epoch_artifacts(out_dir, epoch, va, logits, labels, multilabel)
        seconds = {"train_s": tr["time_s"], "eval_s": eval_s,
                   "artifacts_s": time.perf_counter() - t}
        history.append({"epoch": epoch, "lr": lr, "train": tr, "val": va, "seconds": seconds})
        if plateau is not None:
            plateau.step(va["loss"])
        stop = stopper(va["loss"], model, epoch)
        state = ckpt.training_state(model, optimizer, epoch, history, stopper, plateau,
                                    train_loader, preprocess)
        if save_checkpoints:
            t = time.perf_counter()
            ckpt.save_state(os.path.join(out_dir, "last.pt"), state)
            seconds["last_pt_s"] = time.perf_counter() - t
        if stop:
            log_fn(f"early stop at epoch {epoch} (best epoch {stopper.best_epoch})")
            break
    if state is None:
        state = ckpt.training_state(model, optimizer, first - 1, history, stopper, plateau,
                                    train_loader, preprocess)
    return state, history
