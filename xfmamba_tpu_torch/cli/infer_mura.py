"""MURA inference CLI (port of ``xfmamba_tpu/cli/infer_mura.py``; the
reference's ``2_inference_mura.py``): the per-body-part sweep over the
seven parts (:154-260), softmax[:, 1] scores, per-part and combined ROC /
AUC artefacts (:263-324).  ``--device`` (default ``cuda``) is the port's.

``--cal_flops 1`` and ``--gradcam 1`` raise ``NotImplementedError`` (the
utilities are not ported).  Without ``--pretrained_model_path`` it warns and
scores the seeded initial weights, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from xfmamba_tpu_torch.cli import (
    MURA_BODY_PARTS, UTILITIES_ITEM, collect_scores, inference_apply, write_roc_artifacts)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="XFMamba MURA inference (PyTorch, CUDA)")
    p.add_argument("--model_name", default="twoviewxfmamba")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--pretrained_model_path", required=False, default=None)
    p.add_argument("--data_root", default="")
    p.add_argument("--train_image_csv", default=None)
    p.add_argument("--train_label_csv", default=None)
    p.add_argument("--valid_image_csv", required=True)
    p.add_argument("--valid_label_csv", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_dir", default="inference_mura")
    p.add_argument("--cal_flops", type=int, default=0, help="not ported: raises")
    p.add_argument("--gradcam", type=int, default=0, help="not ported: raises")
    p.add_argument("--body_parts", nargs="*", default=MURA_BODY_PARTS)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag in ("cal_flops", "gradcam"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} 1 is not ported yet ({UTILITIES_ITEM})")
    apply_fn = inference_apply(args, args.num_classes)

    from xfmamba_tpu_torch.data.mura import create_data_loaders
    sz = args.image_size
    cfg_dict = dict(root_dir=args.data_root, seed=args.seed, image_size=(sz, sz),
                    batch_size=args.batch_size, eval_batch_size=args.batch_size,
                    num_workers=args.num_workers)
    os.makedirs(args.out_dir, exist_ok=True)
    all_labels, all_probs, aucs = [], [], {}
    for part in args.body_parts:
        _, _, test_loader = create_data_loaders(
            args.train_image_csv or args.valid_image_csv,
            args.train_label_csv or args.valid_label_csv,
            args.valid_image_csv, args.valid_label_csv, cfg_dict, body_part=part)
        if len(test_loader) == 0:
            print(f"{part}: no studies, skipping")
            continue
        labels, probs, _ = collect_scores(apply_fn, test_loader, binary=True)
        if len(np.unique(labels)) < 2:
            print(f"{part}: single-class fold, skipping AUC")
            continue
        aucs[part] = write_roc_artifacts(args.out_dir, part, labels, probs)
        print(f"{part}: AUC={aucs[part]:.4f} (n={len(labels)})")
        all_labels.append(labels)
        all_probs.append(probs)
    if all_labels:
        labels, probs = np.concatenate(all_labels), np.concatenate(all_probs)
        aucs["combined"] = write_roc_artifacts(args.out_dir, "combined", labels, probs)
        print(f"combined AUC: {aucs['combined']:.4f} (n={len(labels)})")
    return aucs


if __name__ == "__main__":
    main()
