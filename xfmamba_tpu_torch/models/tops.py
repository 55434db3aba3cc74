"""The model tops (port of ``xfmamba_tpu/models/tops.py``): the two-view
XFMamba model (``TwoViewXFMamba``, ``two_view_xfmamba``), the paper's
baselines ``SingleViewMamba``, ``TwoViewLateJoinMamba`` and
``TwoViewEarlyFusionMamba``, and ``ModelWrapper``.

XFMamba runs both views through the shared backbone as one batch of 2B;
the stage-3 features go through the shallow swap fusion, the deep cross
fusion, a 1x1 conv, mean pooling and a linear head.  The baselines use the
"small" backbone whatever their ``hidden_dim`` says, as JAX's do.
``.eval()`` gives the inference path, ``.train()`` the training path
(batch statistics, drop-path masks from the model's ``dropout_generator``,
the training kernels; see ``models/vssm.py`` and ``models/fusion.py``).
Views are NHWC (B, H, W, 1) and the forward computes in their dtype.  The
JAX model's saliency hooks (``sow``/``perturb`` of the stage-3 features)
are forward hooks here, in ``utils/saliency.py``.  Module names are JAX's,
so ``checkpoint/convert.py`` maps every top.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xfmamba_tpu_torch.models.fusion import CSSFVSSLayer, ShallowFusionBlock
from xfmamba_tpu_torch.models.layers import BatchNorm, Conv2dSame, Dense
from xfmamba_tpu_torch.models.vssm import VSSM, build_model

# backbone geometry per model size (``net_fusionmamba.py:151-159``)
_BACKBONE_CFG = dict(
    small=dict(depths=(2, 2, 15, 2), dims=96, drop_path_rate=0.3, ssm_ratio=2.0),
    base=dict(depths=(2, 2, 15, 2), dims=128, drop_path_rate=0.6, ssm_ratio=2.0),
    tiny=dict(depths=(2, 2, 8, 2), dims=96, drop_path_rate=0.2, ssm_ratio=1.0),
)

_BACKBONE_DEFAULTS = dict(ssm_d_state=1, ssm_dt_rank="auto", ssm_conv_bias=False,
                          mlp_ratio=4.0, out_indices=(0, 1, 2, 3))


def _make_backbone(model_type: str, use_checkpoint=False, overrides=None, generator=None,
                   dropout_generator=None) -> VSSM:
    """The shared backbone ``mamba_feature_extrac`` of a model size."""
    cfg = dict(_BACKBONE_DEFAULTS, **_BACKBONE_CFG[model_type])
    cfg.update(overrides or {})
    return VSSM(use_checkpoint=use_checkpoint, generator=generator,
                dropout_generator=dropout_generator, **cfg)


def _stage3_dim(backbone: VSSM) -> int:
    return backbone.outnorm3.weight.shape[0]


def _expand_gray(x):
    """Single-channel views to three channels (``net_fusionmamba.py:59``)."""
    return x.expand(*x.shape[:-1], 3) if x.shape[-1] == 1 else x


class SingleViewMamba(nn.Module):
    """The full VMamba-S s2l15 classifier (`vssm.build_model`) on one view
    expanded to three channels (``net_fusionmamba.py:29-62``)."""

    def __init__(self, outputs: int = 2, use_checkpoint: bool = False, generator=None,
                 dropout_generator=None):
        super().__init__()
        # drop-path masks in training; a CPU generator, seeded by the caller
        self.dropout_generator = dropout_generator or torch.Generator().manual_seed(0)
        self.singleviewmamba = build_model(num_classes=outputs, device=None,
                                           use_checkpoint=use_checkpoint, generator=generator,
                                           dropout_generator=self.dropout_generator)

    def forward(self, x):
        return self.singleviewmamba(_expand_gray(x))


class TwoViewLateJoinMamba(nn.Module):
    """The shared small backbone on 2B images, the two views' stage-3 maps
    concatenated on channels, a mean over the map and the linear head
    (``net_fusionmamba.py:64-96``).  ``hidden_dim`` is accepted and unused,
    as in JAX: the head's width follows the backbone."""

    def __init__(self, outputs: int = 2, hidden_dim: int = 768 * 2,
                 use_checkpoint: bool = False, generator=None, dropout_generator=None):
        super().__init__()
        # drop-path masks in training; a CPU generator, seeded by the caller
        self.dropout_generator = dropout_generator or torch.Generator().manual_seed(0)
        self.mamba_feature_extrac = _make_backbone("small", use_checkpoint, None, generator,
                                                   self.dropout_generator)
        self.classifier_head = Dense(2 * _stage3_dim(self.mamba_feature_extrac), outputs,
                                     init="trunc_normal", generator=generator)

    def forward(self, x_a, x_b):
        Bv = x_a.shape[0]
        z = self.mamba_feature_extrac(
            torch.cat([_expand_gray(x_a), _expand_gray(x_b)], 0))[3]
        return self.classifier_head(torch.cat([z[:Bv], z[Bv:]], -1).mean((1, 2)))


class TwoViewEarlyFusionMamba(nn.Module):
    """Pixel-level fusion (``net_fusionmamba.py:98-138``): the two views'
    3 + 3 channels, a 1x1 conv to 3 (``fusion_conv``), BatchNorm
    (``fusion_bn``), ReLU, the small backbone's stage-3 map, a mean over it
    and the linear head.  ``fusion_bn`` takes the batch's statistics (and
    updates its running ones) only when called with ``train_bn=True``, in
    any mode, as JAX's ``use_running_average=not train_bn``: a training
    step normalises with the running statistics and leaves them as they
    are.  ``hidden_dim`` is accepted and unused, as in JAX."""

    def __init__(self, outputs: int = 2, hidden_dim: int = 768, use_checkpoint: bool = False,
                 generator=None, dropout_generator=None):
        super().__init__()
        # drop-path masks in training; a CPU generator, seeded by the caller
        self.dropout_generator = dropout_generator or torch.Generator().manual_seed(0)
        self.fusion_conv = Conv2dSame(6, 3, 1, generator=generator)
        # flax momentum 0.9 is torch momentum 0.1
        self.fusion_bn = BatchNorm(3, eps=1e-5, momentum=0.1)
        self.mamba_feature_extrac = _make_backbone("small", use_checkpoint, None, generator,
                                                   self.dropout_generator)
        self.classifier_head = Dense(_stage3_dim(self.mamba_feature_extrac), outputs,
                                     init="trunc_normal", generator=generator)

    def forward(self, x_a, x_b, train_bn: bool = False):
        x = self.fusion_conv(torch.cat([_expand_gray(x_a), _expand_gray(x_b)], -1))
        x = F.relu(self.fusion_bn(x, batch_stats=train_bn))
        z = self.mamba_feature_extrac(x)[3]
        return self.classifier_head(z.mean((1, 2)))


class TwoViewXFMamba(nn.Module):
    """THE XFMamba model (``net_fusionmamba.py:141-210``)."""

    def __init__(self, outputs: int = 2, model_type: str = "small",
                 hidden_dim: int = 768, depth: int = 1, d_state: int = 16,
                 drop_path_rate: float = 0.1, use_checkpoint: bool = False,
                 backbone_overrides=None, generator=None, dropout_generator=None):
        super().__init__()
        # drop-path masks in training; a CPU generator, seeded by the caller
        self.dropout_generator = dropout_generator or torch.Generator().manual_seed(0)
        self.mamba_feature_extrac = _make_backbone(model_type, use_checkpoint,
                                                   backbone_overrides, generator,
                                                   self.dropout_generator)
        self.shallow_mamba_fusion = ShallowFusionBlock(
            hidden_dim, d_state=d_state, generator=generator,
            dropout_generator=self.dropout_generator)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.fusemamba = CSSFVSSLayer(hidden_dim, depth, [float(r) for r in dpr],
                                      d_state, generator, self.dropout_generator)
        self.final_conv = Conv2dSame(hidden_dim, hidden_dim, 1, generator=generator)
        self.classifier = nn.ModuleDict(
            {"head": Dense(hidden_dim, outputs, init="trunc_normal", generator=generator)})

    def pack_for_inference(self):
        """`VSSM.pack_for_inference` on the backbone: keep its inference
        operands until ``train()``, `load_state_dict` or a move."""
        self.mamba_feature_extrac.pack_for_inference()
        return self

    def forward(self, x_a, x_b):
        Bv = x_a.shape[0]
        z = self.mamba_feature_extrac(
            torch.cat([_expand_gray(x_a), _expand_gray(x_b)], 0))[3]
        z_a, z_b = self.shallow_mamba_fusion(z[:Bv], z[Bv:])
        z = self.fusemamba(z_a, z_b)
        z = self.final_conv(z).mean((1, 2))
        return self.classifier["head"](z)


def two_view_xfmamba(size: str = "small", outputs: int = 2, *, device="cuda",
                     seed: int = 0, **kw) -> TwoViewXFMamba:
    """Factory mirroring the CLI names (twoviewxfmamba / _tiny / _base).
    Weights are drawn from a ``torch.Generator`` seeded with ``seed``, and
    the drop-path masks of training from one seeded with ``seed + 1``; the
    model is returned in eval mode on ``device`` (the card unless the
    caller asks for the CPU), with float32 weights."""
    generator = torch.Generator().manual_seed(seed)
    hidden = 1024 if size == "base" else 768
    model = TwoViewXFMamba(outputs=outputs, model_type=size, hidden_dim=hidden,
                           generator=generator,
                           dropout_generator=torch.Generator().manual_seed(seed + 1), **kw)
    return model.eval().to(device)


class ModelWrapper(nn.Module):
    """Channel-stacked single-input adapter for saliency tools
    (``net_fusionmamba.py:10-26``): splits (B, H, W, 2C) into the two views
    of ``model``; a tuple output gives its ``output_index``-th item."""

    def __init__(self, model: nn.Module, output_index: int = 0):
        super().__init__()
        self.model = model
        self.output_index = output_index

    def forward(self, x):
        C = x.shape[-1] // 2
        out = self.model(x[..., :C], x[..., C:])
        return out[self.output_index] if isinstance(out, (tuple, list)) else out
