"""Saliency and Grad-CAM for the two-view models (port of
``xfmamba_tpu/utils/saliency.py``; the reference wires pytorch_grad_cam
through ``ModelWrapper``, ``2_inference_mura.py:109-121``, at the
backbone's stage-3 feature maps).

Torch hooks take the place of Flax's ``sow`` / ``perturb``: a forward
pre-hook on the backbone turns autograd off for its forward (the backbone
is not differentiated), and a forward hook hands its stage-3 output on as a
leaf that requires a gradient; ``torch.autograd.grad`` of the class score
with respect to that leaf gives the gradients through the fusion layers,
the final conv and the head.  In eval mode the fusion layers then take
their differentiable kernels (``models/fusion.py``).  Grad-CAM is
``ReLU(sum_c w_c F_c)`` with ``w_c`` the spatial mean of ``d score /
d F_c``, upsampled to the input as ``jax.image.resize(..., "bilinear")``
does and min-max normalised per image, as JAX's ``_cam_from``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from xfmamba_tpu_torch.ops.device_preprocess import resize_bilinear


def _cam_from(features, grads, out_hw: Optional[Tuple[int, int]] = None):
    """features, grads (B, h, w, C) -> CAM (B, H, W) float32 in [0, 1]."""
    weights = grads.float().mean((1, 2), keepdim=True)
    cam = torch.clamp((weights * features.float()).sum(-1), min=0.0)
    if out_hw is not None:
        cam = resize_bilinear(cam, tuple(out_hw), antialias=True)
    lo = cam.amin((1, 2), keepdim=True)
    hi = cam.amax((1, 2), keepdim=True)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-8)


def _stage3_gradients(model, x1, x2, class_idx: int):
    """(features, gradients), each (2B, h, w, C) with view A's B images
    first: the backbone's stage-3 output of both views of ``model``
    (``TwoViewXFMamba``) and the gradient of ``logits[:, class_idx].sum()``
    with respect to it.  The backbone runs without autograd; the model runs
    in eval mode, which is restored."""
    backbone = model.mamba_feature_extrac
    state = {}

    def before(module, args):
        state["grad"] = torch.is_grad_enabled()
        torch.set_grad_enabled(False)

    def after(module, args, out):
        torch.set_grad_enabled(state["grad"])
        leaf = out[3].detach().requires_grad_()
        state["features"] = leaf
        return type(out)([*out[:3], leaf, *out[4:]])

    training = model.training
    model.eval()
    hooks = [backbone.register_forward_pre_hook(before), backbone.register_forward_hook(after)]
    grad = torch.is_grad_enabled()
    try:
        with torch.enable_grad():
            score = model(x1, x2)[:, class_idx].sum()
            features = state["features"]
            (grads,) = torch.autograd.grad(score, features)
    finally:
        torch.set_grad_enabled(grad)
        for h in hooks:
            h.remove()
        model.train(training)
    return features.detach(), grads


def grad_cam_two_view(model, x1, x2, class_idx: int, upsample_to_input: bool = True,
                      return_gradients: bool = False):
    """Grad-CAM heat maps of both views of a two-view model
    (``TwoViewXFMamba``): (cam_a, cam_b), each (B, H, W) float32 in [0, 1],
    and with ``return_gradients`` (features, gradients) after them: the
    backbone's stage-3 output of both views (2B, h, w, C), view A's first,
    and the gradient of ``logits[:, class_idx].sum()`` with respect to it."""
    features, grads = _stage3_gradients(model, x1, x2, class_idx)
    B = x1.shape[0]
    out_hw = tuple(x1.shape[1:3]) if upsample_to_input else None
    cams = (_cam_from(features[:B], grads[:B], out_hw),
            _cam_from(features[B:], grads[B:], out_hw))
    return cams + ((features, grads),) if return_gradients else cams


def input_saliency(apply_fn: Callable, x1, x2, class_idx: int):
    """Vanilla input-gradient saliency ``|d logit_c / d x|`` per view, the
    largest over channels: (B, H, W) each.  ``apply_fn(x1, x2)`` must be
    differentiable (on the card, a model in training mode, or one whose
    eval routes are: the fusion layers' are, the bfloat16 backbone's stage
    kernels are not)."""
    a = x1.detach().requires_grad_()
    b = x2.detach().requires_grad_()
    with torch.enable_grad():
        score = apply_fn(a, b)[:, class_idx].sum()
        g1, g2 = torch.autograd.grad(score, (a, b))
    return g1.abs().amax(-1), g2.abs().amax(-1)


def overlay(img, cam, alpha: float = 0.5):
    """Blend a [0, 1] grayscale image (H, W) with a CAM (H, W) into an
    (H, W, 3) red-highlight overlay (the DDSM inference script's
    ``_overlay_mask`` analogue, ``dataset_ddsmxray_twoview.py:621``)."""
    img = torch.clamp(torch.as_tensor(img, dtype=torch.float32), 0.0, 1.0)
    cam = torch.as_tensor(cam, dtype=torch.float32)
    base = torch.stack([img, img, img], -1)
    heat = torch.stack([cam, torch.zeros_like(cam), torch.zeros_like(cam)], -1)
    return (1 - alpha * cam[..., None]) * base + alpha * heat
