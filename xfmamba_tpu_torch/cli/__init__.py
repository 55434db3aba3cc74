"""CLI layer (port of ``xfmamba_tpu/cli/__init__.py``; the reference's
``1_train_model.py`` and ``2_inference_*.py``).

Shared helpers: the model-name dispatch (``1_train_model.py:122-127``),
checkpoint loading (``.npz`` in the JAX layout, or a torch state dict with
the reference's names), inference over a loader and the ROC artefacts
(``2_inference_mura.py:263-324``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

# MURA body parts (``2_inference_mura.py:154``)
MURA_BODY_PARTS = ["ELBOW", "FINGER", "FOREARM", "HAND", "HUMERUS", "SHOULDER", "WRIST"]

UTILITIES_ITEM = "ROADMAP.md, queue 1: the utilities (utils/flops.py, utils/saliency.py)"


def _seeded(cls, device, seed, **kw):
    """``cls(**kw)`` with weights from a generator seeded with ``seed`` and
    drop-path masks from one seeded with ``seed + 1``, in eval mode on
    ``device``."""
    model = cls(generator=torch.Generator().manual_seed(seed),
                dropout_generator=torch.Generator().manual_seed(seed + 1), **kw)
    return model.eval().to(device)


def build_model_by_name(model_name: str, num_classes: int, device="cuda", seed: int = 0,
                        use_checkpoint: bool = False):
    """The CLI model names (``1_train_model.py:122-127`` and the single-view,
    late-join and early-fusion tops of ``net_fusionmamba.py``): returns
    (model, two_view), the model on ``device`` in eval mode with float32
    weights drawn from a generator seeded with ``seed`` (the drop-path
    masks' from ``seed + 1``).  The compute dtype is the views'.  An
    unknown name raises ``ValueError``."""
    from xfmamba_tpu_torch.models import tops
    name = model_name.lower()
    if name == "twoviewxfmamba_smoke":
        # the tiny geometry of CI smoke runs
        return _seeded(tops.TwoViewXFMamba, device, seed, outputs=num_classes,
                       model_type="tiny", hidden_dim=128, d_state=4,
                       use_checkpoint=use_checkpoint,
                       backbone_overrides=dict(depths=(1, 1, 1, 1), dims=16)), True
    sizes = {"twoviewxfmamba": "small", "dualfusionmambav13": "small",
             "twoviewxfmamba_tiny": "tiny", "twoviewxfmamba_base": "base"}
    if name in sizes:
        # `dualfusionmambav13` is the README's legacy name for the small model
        return tops.two_view_xfmamba(sizes[name], outputs=num_classes, device=device, seed=seed,
                                     use_checkpoint=use_checkpoint), True
    baselines = {"singleviewmamba": (tops.SingleViewMamba, False),
                 "twoviewlatejoinmamba": (tops.TwoViewLateJoinMamba, True),
                 "twoviewearlyfusionmamba": (tops.TwoViewEarlyFusionMamba, True)}
    if name in baselines:
        cls, two_view = baselines[name]
        return _seeded(cls, device, seed, outputs=num_classes,
                       use_checkpoint=use_checkpoint), two_view
    raise ValueError(f"unknown model_name {model_name!r}")


def load_variables(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint into ``model``: a ``.npz`` in the JAX layout
    (either package's ``best.npz``), or a ``.pth`` / ``.pt`` / ``.bin``
    torch file holding a state dict with the reference's names (bare, or
    under ``"model"`` as in the port's ``last.pt``, or ``"state_dict"``)."""
    if path.endswith(".npz"):
        from xfmamba_tpu_torch.checkpoint.io import load_model_npz
        return load_model_npz(path, model)
    if path.endswith((".pth", ".pt", ".bin")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        model.load_state_dict(sd)
        return model
    raise ValueError(f"unsupported checkpoint format: {path}")


def write_roc_artifacts(out_dir: str, tag: str, labels: np.ndarray, scores: np.ndarray) -> float:
    """``auc_{tag}.txt`` and, with matplotlib, ``roc_{tag}.png``.  Returns
    the AUC."""
    from xfmamba_tpu_torch.train.metrics import roc_auc, roc_curve_points
    os.makedirs(out_dir, exist_ok=True)
    auc = roc_auc(labels, scores)
    fpr, tpr, _ = roc_curve_points(labels, scores)
    with open(os.path.join(out_dir, f"auc_{tag}.txt"), "w") as f:
        f.write(f"{tag} AUC: {auc:.6f}\n")
        f.write(f"n = {len(labels)}\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(fpr, tpr, label=f"{tag} (AUC={auc:.4f})")
        ax.plot([0, 1], [0, 1], "k--", lw=0.8)
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.legend(loc="lower right")
        fig.savefig(os.path.join(out_dir, f"roc_{tag}.png"), dpi=120)
        plt.close(fig)
    except Exception:
        pass
    return auc


def make_eval_apply(model: torch.nn.Module, two_view: bool, dtype=torch.float32):
    """``apply(x1, x2)`` on numpy views: moved to the model's device in
    ``dtype``, one eval forward without gradients; returns the logits as
    float32 numpy."""
    device = next(model.parameters()).device
    model.eval()

    @torch.no_grad()
    def apply_fn(x1, x2):
        views = [torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)
                 for x in ((x1, x2) if two_view else (x1,))]
        return model(*views).float().cpu().numpy()
    return apply_fn


def inference_apply(args, num_classes: int):
    """The inference CLIs' model: ``--model_name`` with ``num_classes``
    outputs on ``--device``, its weights from ``--pretrained_model_path``
    (or, with a warning, the seeded initial ones, as in JAX), wrapped by
    `make_eval_apply` in ``--bf16``'s dtype."""
    model, two_view = build_model_by_name(args.model_name, num_classes, device=args.device,
                                          seed=args.seed)
    if args.pretrained_model_path:
        load_variables(args.pretrained_model_path, model)
    else:
        print("WARNING: no checkpoint given; using random init")
    return make_eval_apply(model, two_view, torch.bfloat16 if args.bf16 else torch.float32)


def collect_scores(apply_fn, loader, binary: bool = True):
    """Run inference over a loader; returns (labels, probs, batch_times_s),
    each batch's ``n_valid`` rows.  ``binary``: probs = softmax[:, 1]
    (``2_inference_mura.py:187``), else sigmoid(logits)."""
    all_labels, all_probs, times = [], [], []
    for batch in loader:
        nv = batch.get("n_valid", batch["label"].shape[0])
        t0 = time.perf_counter()
        logits = apply_fn(batch["image1"], batch["image2"])[:nv]
        times.append(time.perf_counter() - t0)
        if binary:
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs = (e / e.sum(axis=1, keepdims=True))[:, 1]
        else:
            probs = 1.0 / (1.0 + np.exp(-logits))
        all_probs.append(probs)
        all_labels.append(np.asarray(batch["label"])[:nv])
    return np.concatenate(all_labels), np.concatenate(all_probs), times
