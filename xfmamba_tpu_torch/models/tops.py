"""The two-view XFMamba model (port of ``xfmamba_tpu/models/tops.py``:
``_expand_gray``, ``TwoViewXFMamba``, ``two_view_xfmamba``).

Both views run through the shared backbone as one batch of 2B; the
stage-3 features go through the shallow swap fusion, the deep cross fusion,
a 1x1 conv, mean pooling and a linear head.  ``.eval()`` gives the
inference path, ``.train()`` the training path (batch statistics, drop-path
masks from the model's ``dropout_generator``, the training kernels; see
``models/vssm.py`` and ``models/fusion.py``).  The saliency hooks of the
JAX model (``sow``/``perturb``) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from xfmamba_tpu_torch.models.fusion import CSSFVSSLayer, ShallowFusionBlock
from xfmamba_tpu_torch.models.layers import Conv2dSame, Dense
from xfmamba_tpu_torch.models.vssm import VSSM

# backbone geometry per model size (``net_fusionmamba.py:151-159``)
_BACKBONE_CFG = dict(
    small=dict(depths=(2, 2, 15, 2), dims=96, drop_path_rate=0.3, ssm_ratio=2.0),
    base=dict(depths=(2, 2, 15, 2), dims=128, drop_path_rate=0.6, ssm_ratio=2.0),
    tiny=dict(depths=(2, 2, 8, 2), dims=96, drop_path_rate=0.2, ssm_ratio=1.0),
)

_BACKBONE_DEFAULTS = dict(ssm_d_state=1, ssm_dt_rank="auto", ssm_conv_bias=False,
                          mlp_ratio=4.0, out_indices=(0, 1, 2, 3))


def _expand_gray(x):
    """Single-channel views to three channels (``net_fusionmamba.py:59``)."""
    return x.expand(*x.shape[:-1], 3) if x.shape[-1] == 1 else x


class TwoViewXFMamba(nn.Module):
    """THE XFMamba model (``net_fusionmamba.py:141-210``).  Views are NHWC
    (B, H, W, 1); the forward computes in the views' dtype."""

    def __init__(self, outputs: int = 2, model_type: str = "small",
                 hidden_dim: int = 768, depth: int = 1, d_state: int = 16,
                 drop_path_rate: float = 0.1, use_checkpoint: bool = False,
                 backbone_overrides=None, generator=None, dropout_generator=None):
        super().__init__()
        # drop-path masks in training; a CPU generator, seeded by the caller
        self.dropout_generator = dropout_generator or torch.Generator().manual_seed(0)
        cfg = dict(_BACKBONE_DEFAULTS, **_BACKBONE_CFG[model_type])
        cfg.update(backbone_overrides or {})
        self.mamba_feature_extrac = VSSM(use_checkpoint=use_checkpoint, generator=generator,
                                         dropout_generator=self.dropout_generator, **cfg)
        self.shallow_mamba_fusion = ShallowFusionBlock(
            hidden_dim, d_state=d_state, generator=generator,
            dropout_generator=self.dropout_generator)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.fusemamba = CSSFVSSLayer(hidden_dim, depth, [float(r) for r in dpr],
                                      d_state, generator, self.dropout_generator)
        self.final_conv = Conv2dSame(hidden_dim, hidden_dim, 1, generator=generator)
        self.classifier = nn.ModuleDict(
            {"head": Dense(hidden_dim, outputs, init="trunc_normal", generator=generator)})

    def forward(self, x_a, x_b):
        Bv = x_a.shape[0]
        z = self.mamba_feature_extrac(
            torch.cat([_expand_gray(x_a), _expand_gray(x_b)], 0))[3]
        z_a, z_b = self.shallow_mamba_fusion(z[:Bv], z[Bv:])
        z = self.fusemamba(z_a, z_b)
        z = self.final_conv(z).mean((1, 2))
        return self.classifier["head"](z)


def two_view_xfmamba(size: str = "small", outputs: int = 2, *, device="cpu",
                     seed: int = 0, **kw) -> TwoViewXFMamba:
    """Factory mirroring the CLI names (twoviewxfmamba / _tiny / _base).
    Weights are drawn from a ``torch.Generator`` seeded with ``seed``, and
    the drop-path masks of training from one seeded with ``seed + 1``; the
    model is returned in eval mode on ``device``, with float32 weights."""
    generator = torch.Generator().manual_seed(seed)
    hidden = 1024 if size == "base" else 768
    model = TwoViewXFMamba(outputs=outputs, model_type=size, hidden_dim=hidden,
                           generator=generator,
                           dropout_generator=torch.Generator().manual_seed(seed + 1), **kw)
    return model.eval().to(device)
