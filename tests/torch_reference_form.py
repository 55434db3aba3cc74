"""A port state dict written as the PyTorch reference writes its
checkpoints (for the CPU tests and ``chip_smoke.py``; no JAX here): the
fusion blocks' dead ``self_attention.in_proj``, thop's ``total_ops`` /
``total_params``, VMamba's legacy backbone names (``ln_1``,
``self_attention``, ``patch_embed.proj`` / ``.norm``, a top-level ``norm.``
/ ``head.``), ``Linear2d`` weights stored as (out, in, 1, 1) and no
``num_batches_tracked``."""

from __future__ import annotations

import re

import numpy as np
import torch

LINEAR = re.compile(r"(in_proj|in_proj_sec|out_proj|mlp\.fc[12]|reduction|fc1\.\d)\.weight$")


def legacy_backbone_key(k: str) -> str:
    """The name VMamba's older checkpoints give a backbone key."""
    k = k.replace("patch_embed.0.", "patch_embed.proj.").replace("patch_embed.2.",
                                                                 "patch_embed.norm.")
    k = re.sub(r"(layers\.\d+\.blocks\.\d+\.)norm\.", r"\1ln_1.", k)
    k = re.sub(r"(layers\.\d+\.blocks\.\d+\.)op\.", r"\1self_attention.", k)
    return re.sub(r"^classifier\.(norm|head)\.", r"\1.", k)


def reference_form(state: dict, rng: np.random.Generator,
                   prefix: str = "mamba_feature_extrac.") -> dict:
    """``state`` as the reference writes it (the module docstring); the
    backbone's keys are those under ``prefix`` ("" for a bare VSSM)."""
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.detach().clone()
        if LINEAR.search(k) and v.ndim == 2:
            v = v[:, :, None, None]
        if k.startswith(prefix):
            k = prefix + legacy_backbone_key(k[len(prefix):])
        out[k] = v
    for k in list(out):
        m = re.match(r"(fusemamba\.blocks\.\d+\.self_attention\.)in_proj_sec\.weight$", k)
        if m:
            d_inner, d_model = out[k].shape[:2]
            dead = rng.standard_normal((2 * d_inner, d_model)).astype(np.float32)
            out[m.group(1) + "in_proj.weight"] = torch.from_numpy(dead)
            out[m.group(1) + "in_proj.bias"] = torch.from_numpy(
                rng.standard_normal(2 * d_inner).astype(np.float32))
    out["total_ops"] = torch.zeros(1, dtype=torch.float64)
    out["total_params"] = torch.zeros(1, dtype=torch.float64)
    out[f"{prefix}layers.0.total_ops"] = torch.zeros(1, dtype=torch.float64)
    return out
