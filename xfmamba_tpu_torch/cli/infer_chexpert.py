"""CheXpert inference CLI (port of ``xfmamba_tpu/cli/infer_chexpert.py``;
the reference's ``2_inference_chexpert.py``): the seeded 75/12.5/12.5
split's test fold (:110-117), sigmoid scores with per-class and mean AUC
over the 14 labels, or 13 with ``--drop_no_finding 1`` (:123-128,
:270-280), and the timing report with FPS written to
``inference_timing.txt`` (:233-266).  ``--device`` (default ``cuda``) is
the port's.

The classes are named in the label vector's order (`data.chexpert.LABELS`,
"No Finding" last).  JAX names them from a list with "No Finding" first, so
at 14 classes each of its names is one column off; its AUCs are the
same, column by column.  Without ``--pretrained_model_path`` it warns and
scores the seeded initial weights, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from xfmamba_tpu_torch.cli import collect_scores, inference_apply, write_roc_artifacts
from xfmamba_tpu_torch.utils.profiling import format_timing_report, timing_stats


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="XFMamba CheXpert inference (PyTorch, CUDA)")
    p.add_argument("--model_name", default="twoviewxfmamba")
    p.add_argument("--num_classes", type=int, default=14)
    p.add_argument("--drop_no_finding", type=int, default=0,
                   help="13-class protocol (README vs code mismatch, SURVEY.md §6)")
    p.add_argument("--pretrained_model_path", default=None)
    p.add_argument("--data_root", required=True)
    p.add_argument("--csv_file", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_dir", default="inference_chexpert")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {"mean_auc", "per_class": {name: AUC}, "timing": stats}."""
    args = parse_args(argv)
    n_classes = 13 if args.drop_no_finding else args.num_classes
    apply_fn = inference_apply(args, n_classes)

    from xfmamba_tpu_torch.data.chexpert import LABELS, create_train_val_test_data_loaders
    sz = args.image_size
    cfg_dict = dict(seed=args.seed, image_size=(sz, sz), batch_size=args.batch_size,
                    eval_batch_size=args.batch_size, num_workers=args.num_workers)
    _, _, test_loader = create_train_val_test_data_loaders(
        [args.data_root], [args.csv_file], cfg_dict, drop_no_finding=bool(args.drop_no_finding))
    labels, probs, times = collect_scores(apply_fn, test_loader, binary=False)

    os.makedirs(args.out_dir, exist_ok=True)
    from xfmamba_tpu_torch.train.metrics import roc_auc
    names = [n for n in LABELS if not (args.drop_no_finding and n == "No Finding")][:n_classes]
    per_class = {}
    for i, name in enumerate(names):
        positive = (labels[:, i] > 0.5).astype(int)
        if len(np.unique(positive)) < 2:
            continue
        per_class[name] = roc_auc(positive, probs[:, i])
        write_roc_artifacts(args.out_dir, name.replace(" ", "_"), positive, probs[:, i])
    mean_auc = float(np.mean(list(per_class.values()))) if per_class else float("nan")
    with open(os.path.join(args.out_dir, "per_class_auc.txt"), "w") as f:
        for name, auc in per_class.items():
            f.write(f"{name}: {auc:.6f}\n")
        f.write(f"\nmean AUC ({len(per_class)} classes): {mean_auc:.6f}\n")
    print(f"mean AUC over {len(per_class)} classes: {mean_auc:.4f}")

    stats = timing_stats(times, batch_size=args.batch_size)
    report = format_timing_report(stats, header="CheXpert inference timing")
    with open(os.path.join(args.out_dir, "inference_timing.txt"), "w") as f:
        f.write(report + "\n")
    print(report)
    return {"mean_auc": mean_auc, "per_class": per_class, "timing": stats}


if __name__ == "__main__":
    main()
