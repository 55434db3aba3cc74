"""Training CLI (port of ``xfmamba_tpu/cli/train.py``; the reference's
``1_train_model.py``).  Every flag of the JAX CLI, plus ``--device``
(default ``cuda``).  ``fit`` writes ``last.pt`` every epoch;
``driver.fit(..., init_state=checkpoint.io.load_state(path))`` resumes.

Usage (MURA, on the card):
    python -m xfmamba_tpu_torch.cli.train --dataset mura \\
        --model_name twoviewxfmamba --num_classes 2 \\
        --data_root /data --train_image_csv MURA-v1.1/train_image_paths.csv \\
        --train_label_csv MURA-v1.1/train_labeled_studies.csv \\
        --valid_image_csv MURA-v1.1/valid_image_paths.csv \\
        --valid_label_csv MURA-v1.1/valid_labeled_studies.csv \\
        --savemodel_path runs/mura_small

Every dataset of the JAX CLI: ``mura`` (the four CSV flags), ``chexpert``
(``--data_root`` and ``--chexpert_csv``; multilabel, as ``fit`` trains it,
with ``--num_classes 14``), ``hipxray``
(``--hip_images_dir``, ``--hip_csv``) and ``ddsmxray`` (``--data_root``,
``--ddsm_metadata_csv``, ``--ddsm_case_csvs``); for the last two the
validation split is also the test split, as in JAX.
``--device_preprocess 1`` stages uint8 in the loaders and runs resize,
crop, flip, rotation and normalize on the card (`device_stage`: CheXpert's
stage, CBIS-DDSM's, else MURA's, as JAX's CLI picks; hip X-rays stage
uint8 too, where JAX's loader does not).  A single-view model
(``singleviewmamba``) trains and is evaluated on ``image1`` alone.
``--pretrained_model_path`` is accepted and, as in the JAX package, not
read by ``fit``.

Data parallelism (``--data_parallel 1``, the default), one process a card:
under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) each rank trains on ``cuda:LOCAL_RANK`` (NCCL; gloo for
``--device cpu`` or where ``XFMAMBA_DIST_BACKEND`` names it) and ``fit``
splits every global ``--batch_size`` over the ranks; started plainly with
more than one visible card, the CLI starts one rank a card itself, as JAX's
CLI shards over every local device.  Rank 0 alone prints and writes files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from xfmamba_tpu_torch.cli import build_model_by_name
from xfmamba_tpu_torch.train.config import TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="XFMamba training (PyTorch, CUDA)")
    # reference flags (1_train_model.py:29-55)
    p.add_argument("--dataset", default="mura",
                   choices=["mura", "chexpert", "ddsmxray", "hipxray"])
    p.add_argument("--model_name", default="twoviewxfmamba")
    p.add_argument("--num_tasks", type=int, default=1)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--view_num", type=int, default=2)
    p.add_argument("--view_sel", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--wandb", type=int, default=0)
    p.add_argument("--pretrained_model_path", default=None)
    p.add_argument("--savemodel_path", default="runs")
    # optimizer and scheduler (libs/utils.py:83-134; defaults 1_train_model.py)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "adamw"])
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--scheduler", default="step", choices=["step", "cos", "reduce", "none"])
    p.add_argument("--step_size", type=int, default=10)
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--image_size", type=int, default=224)
    # data paths
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
    # execution
    p.add_argument("--bf16", type=int, default=0,
                   help="bfloat16 views (the stage kernels); float32 weights")
    p.add_argument("--use_checkpoint", type=int, default=0,
                   help="activation recomputation in the backbone")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split each batch over the ranks (torchrun's, or one a visible card)")
    p.add_argument("--device_preprocess", type=int, default=0,
                   help="stage uint8 on the host; resize, augment and normalize on the card")
    p.add_argument("--loader_processes", type=int, default=0,
                   help="decode and transform in worker processes instead of threads")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def make_config(args):
    """(TrainConfig, the loaders' config dict) of parsed arguments."""
    cfg = TrainConfig(
        dataset=args.dataset, data_root=args.data_root,
        image_size=(args.image_size, args.image_size),
        batch_size=args.batch_size, eval_batch_size=args.batch_size,
        num_workers=args.num_workers, seed=args.seed,
        model_name=args.model_name, num_tasks=args.num_tasks,
        num_classes=args.num_classes, view_num=args.view_num, view_sel=args.view_sel,
        pretrained_model_path=args.pretrained_model_path,
        savemodel_path=args.savemodel_path, optimizer=args.optimizer,
        lr=args.lr, weight_decay=args.weight_decay, scheduler=args.scheduler,
        step_size=args.step_size, gamma=args.gamma, epochs=args.epochs,
        patience=args.patience, compute_dtype="bfloat16" if args.bf16 else "float32",
        use_checkpoint=bool(args.use_checkpoint), data_parallel=bool(args.data_parallel),
        wandb=bool(args.wandb))
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["root_dir"] = cfg.data_root
    cfg_dict["device_preprocess"] = bool(args.device_preprocess)
    cfg_dict["loader_processes"] = bool(args.loader_processes)
    return cfg, cfg_dict


def build_loaders(args, cfg_dict):
    """(train, val, test) loaders of ``--dataset`` (JAX's ``build_loaders``)."""
    if args.dataset == "mura":
        from xfmamba_tpu_torch.data.mura import create_data_loaders
        return create_data_loaders(args.train_image_csv, args.train_label_csv,
                                   args.valid_image_csv, args.valid_label_csv, cfg_dict)
    if args.dataset == "chexpert":
        from xfmamba_tpu_torch.data.chexpert import create_train_val_test_data_loaders
        return create_train_val_test_data_loaders([args.data_root], [args.chexpert_csv],
                                                  cfg_dict)
    if args.dataset == "ddsmxray":
        from xfmamba_tpu_torch.data.ddsm import create_data_loaders
        tr, va = create_data_loaders(args.ddsm_case_csvs, args.ddsm_metadata_csv,
                                     args.data_root, cfg_dict)
        return tr, va, va
    if args.dataset == "hipxray":
        from xfmamba_tpu_torch.data.hipxray import create_data_loaders
        tr, va, _ = create_data_loaders(args.hip_images_dir, args.hip_csv, cfg_dict)
        return tr, va, va
    raise ValueError(args.dataset)


def device_stage(args, seed: int):
    """The device stage of ``--dataset`` (JAX's CLI's choice), its
    generator seeded with ``seed``; None without ``--device_preprocess``."""
    if not args.device_preprocess:
        return None
    from xfmamba_tpu_torch.data import device_pipeline as dp
    size = (args.image_size, args.image_size)
    make = {"chexpert": dp.chexpert_device_preprocess,
            "ddsmxray": dp.ddsm_device_preprocess}.get(args.dataset, dp.mura_device_preprocess)
    return make(size, seed=seed)


def local_ranks(args) -> int:
    """The ranks that `main` starts itself: one a visible card, where it is
    started plainly (no torchrun environment) on CUDA with
    ``--data_parallel 1`` and more than one card is visible; else 0."""
    if (not args.data_parallel or "WORLD_SIZE" in os.environ
            or torch.device(args.device).type != "cuda"):
        return 0
    n = torch.cuda.device_count()
    return n if n > 1 else 0


def _rank_main(rank: int, argv, world: int, port: int) -> None:
    """One of `local_ranks`' processes: torchrun's environment, then `main`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    main(argv)


def main(argv=None):
    args = parse_args(argv)
    from xfmamba_tpu_torch.parallel.distributed import (
        ensure_initialized, free_port, is_primary, local_device)
    world = local_ranks(args)
    if world:
        argv = sys.argv[1:] if argv is None else list(argv)
        torch.multiprocessing.spawn(_rank_main, args=(argv, world, free_port()), nprocs=world)
        from xfmamba_tpu_torch.checkpoint.io import load_state
        state = load_state(os.path.join(args.savemodel_path, "last.pt"))
        return state, state["history"]
    started = False
    if args.data_parallel and not dist.is_initialized():
        ensure_initialized(backend="gloo" if torch.device(args.device).type == "cpu" else None)
        started = dist.is_initialized()
    try:
        return _train(args, local_device(args.device), is_primary())
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device, primary: bool):
    cfg, cfg_dict = make_config(args)
    if cfg.wandb and primary:
        try:
            import wandb as _wandb
            _wandb.init(project=f"xfmamba-{cfg.dataset}", config=cfg_dict)
        except Exception as e:  # keep training if wandb is unavailable
            print(f"wandb disabled: {e}")
            cfg = dataclasses.replace(cfg, wandb=False)
    train_loader, val_loader, _ = build_loaders(args, cfg_dict)
    model, two_view = build_model_by_name(cfg.model_name, cfg.num_classes, device=device,
                                          seed=cfg.seed, use_checkpoint=cfg.use_checkpoint)
    from xfmamba_tpu_torch.train.driver import fit
    device = next(model.parameters()).device
    if primary:
        os.makedirs(cfg.savemodel_path, exist_ok=True)
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
              + (f", rank 0 of {dist.get_world_size()} over {dist.get_backend()}"
                 if dist.is_initialized() else ""))
    state, history = fit(model, cfg, train_loader, val_loader, out_dir=cfg.savemodel_path,
                         two_view=two_view, preprocess=device_stage(args, cfg.seed + 2))
    if primary:
        print(f"done; best val loss {min(h['val']['loss'] for h in history):.4f}")
    return state, history


if __name__ == "__main__":
    main()
