"""CBIS-DDSM inference CLI (port of ``xfmamba_tpu/cli/infer_ddsm.py``; the
working equivalent of the reference's ``2_inference_ddsmxray.py``): the
80/20 split's test fold scored twice, plain and with the ROI blended in
(the reference zips two test loaders, :146-148), softmax[:, 1] scores and
ROC / AUC artefacts per pass.  ``--crop 1`` takes the NYU breast crop,
``--rescale_factor`` rescales each view first.  ``--device`` (default
``cuda``) is the port's.  Without ``--pretrained_model_path`` it warns and
scores the seeded initial weights, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from xfmamba_tpu_torch.cli import collect_scores, inference_apply, write_roc_artifacts


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="XFMamba CBIS-DDSM inference (PyTorch, CUDA)")
    p.add_argument("--model_name", default="twoviewxfmamba")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--pretrained_model_path", default=None)
    p.add_argument("--base_dir", required=True, help="CBIS-DDSM root containing the DICOM tree")
    p.add_argument("--metadata_csv", required=True)
    p.add_argument("--case_csvs", nargs="+", required=True,
                   help="mass/calc case description CSVs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--crop", type=int, default=0, help="NYU breast crop")
    p.add_argument("--rescale_factor", type=float, default=None)
    p.add_argument("--overlay_pass", type=int, default=1,
                   help="also evaluate the ROI-overlay variant")
    p.add_argument("--out_dir", default="inference_ddsm")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {pass: AUC} ("plain", and "overlay" with ``--overlay_pass
    1``; a pass whose fold holds one class is skipped, as in JAX)."""
    args = parse_args(argv)
    apply_fn = inference_apply(args, args.num_classes)

    from xfmamba_tpu_torch.data.ddsm import load_subjects, make_load_fn, reference_split
    from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
    from xfmamba_tpu_torch.data.transforms import TwoViewTransform

    sz = args.image_size
    os.makedirs(args.out_dir, exist_ok=True)
    subjects = load_subjects(args.case_csvs, args.metadata_csv, args.base_dir)
    _, test_idx = reference_split(subjects)
    et = TwoViewTransform((sz, sz), train=False, normalize_mean=None, normalize_std=None)
    results = {}
    for tag, overlay in [("plain", False)] + [("overlay", True)] * bool(args.overlay_pass):
        load = make_load_fn(subjects, crop=bool(args.crop), rescale_factor=args.rescale_factor,
                            overlay_mask=overlay)
        loader = TwoViewLoader(TwoViewSamples(test_idx, load, et), args.batch_size,
                               shuffle=False, num_workers=args.num_workers, seed=args.seed)
        labels, probs, _ = collect_scores(apply_fn, loader, binary=True)
        if len(np.unique(labels)) < 2:
            print(f"{tag}: single-class fold, skipping AUC")
            continue
        auc = write_roc_artifacts(args.out_dir, tag, labels, probs)
        print(f"{tag}: AUC={auc:.4f} (n={len(labels)})")
        results[tag] = auc
    return results


if __name__ == "__main__":
    main()
