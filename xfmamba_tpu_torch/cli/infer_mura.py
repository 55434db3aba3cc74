"""MURA inference CLI (port of ``xfmamba_tpu/cli/infer_mura.py``; the
reference's ``2_inference_mura.py``): the per-body-part sweep over the
seven parts (:154-260), softmax[:, 1] scores, per-part and combined ROC /
AUC artefacts (:263-324).  ``--device`` (default ``cuda``) is the port's.

``--cal_flops 1`` prints the parameters and GFLOPs of one batch-1 forward
(`utils.flops.model_flops`, whose FLOPs are defined otherwise than XLA's
cost analysis in JAX) and returns.  ``--gradcam 1`` writes, after the AUC
sweep, ``gradcam.npz`` (``cam_a``, ``cam_b``, ``image1``, ``image2``) for the
first batch of the validation CSV (`utils.saliency.grad_cam_two_view`,
class 1) and, where matplotlib imports, ``gradcam_overlay_{i}.png`` for up
to eight studies.  Without ``--pretrained_model_path`` it warns and scores
the seeded initial weights, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from xfmamba_tpu_torch.cli import (
    MURA_BODY_PARTS, collect_scores, inference_model, make_eval_apply, write_roc_artifacts)
from xfmamba_tpu_torch.data.mura import create_data_loaders
from xfmamba_tpu_torch.utils.flops import model_flops
from xfmamba_tpu_torch.utils.saliency import grad_cam_two_view, overlay


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
    p.add_argument("--cal_flops", type=int, default=0)
    p.add_argument("--gradcam", type=int, default=0,
                   help="export Grad-CAM heatmaps for the first test batch")
    p.add_argument("--body_parts", nargs="*", default=MURA_BODY_PARTS)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    model, two_view = inference_model(args, args.num_classes)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    device = next(model.parameters()).device
    sz = args.image_size
    if args.cal_flops:
        x = torch.zeros(1, sz, sz, 1, dtype=dtype, device=device)
        out = model_flops(model, *((x, x) if two_view else (x,)))
        print(f"params: {out['params'] / 1e6:.2f} M")
        print(f"flops : {out['flops'] / 1e9:.2f} GFLOPs (batch 1)")
        return out
    apply_fn = make_eval_apply(model, two_view, dtype)
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
    if args.gradcam:
        _, _, test_loader = create_data_loaders(args.valid_image_csv, args.valid_label_csv,
                                                args.valid_image_csv, args.valid_label_csv,
                                                cfg_dict)
        write_gradcam(model, next(iter(test_loader)), dtype, args.out_dir)
    return aucs


def write_gradcam(model, batch, dtype, out_dir: str):
    """``gradcam.npz`` of a batch (class 1's CAMs of both views, the views)
    and, with matplotlib, up to eight ``gradcam_overlay_{i}.png``, each view
    min-max scaled to [0, 1] under its CAM (the reference's plot path,
    ``2_inference_mura.py:189-252``).  Returns (cam_a, cam_b) as numpy."""
    device = next(model.parameters()).device
    x1, x2 = (torch.from_numpy(np.ascontiguousarray(batch[k])).to(device=device, dtype=dtype)
              for k in ("image1", "image2"))
    cam_a, cam_b = (c.cpu().numpy() for c in grad_cam_two_view(model, x1, x2, class_idx=1))
    np.savez(os.path.join(out_dir, "gradcam.npz"), cam_a=cam_a, cam_b=cam_b,
             image1=batch["image1"], image2=batch["image2"])
    print(f"Grad-CAM saved to {out_dir}/gradcam.npz")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"Grad-CAM overlay rendering skipped: {e}")
        return cam_a, cam_b
    n_show = min(8, cam_a.shape[0])
    for i in range(n_show):
        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        for ax, img, cam, name in ((axes[0], batch["image1"][i, ..., 0], cam_a[i], "view A"),
                                   (axes[1], batch["image2"][i, ..., 0], cam_b[i], "view B")):
            img = np.asarray(img, np.float32)
            span = img.max() - img.min()
            img = (img - img.min()) / (span if span > 0 else 1.0)
            ax.imshow(overlay(img, cam).numpy())
            ax.set_title(f"Grad-CAM {name}")
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"gradcam_overlay_{i}.png"), dpi=120)
        plt.close(fig)
    print(f"Grad-CAM overlays saved to {out_dir}/gradcam_overlay_*.png ({n_show} samples)")
    return cam_a, cam_b


if __name__ == "__main__":
    main()
