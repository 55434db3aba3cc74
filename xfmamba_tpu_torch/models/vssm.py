"""VSSM backbone in backbone mode (port of ``xfmamba_tpu/models/vssm.py``):
PatchEmbedV2, DownsampleV3, VSSBlock and VSSM with ``out_indices``.

Module and parameter names follow the reference PyTorch state dict
(``patch_embed.{0,2,5,7}``, ``layers.{i}.blocks.{j}``,
``layers.{i}.downsample.{1,3}``, ``outnorm{i}``), so a port ``state_dict()``
converts with ``xfmamba_tpu.checkpoint.convert.convert_vssm_state_dict``.

In eval mode the stage loop runs each stage through
`ops.vss_stage.vss_stage` (kernel 1).  In training mode every block's two
drop-path scales (SS2D half, then MLP half) are drawn from the model's
dropout generator before the step's first launch and copied to the device
at once (`VSSM._drop_path_scales`); `VSSM._train_stage` packs the operands
on the autograd graph, and a stage of depth >= 2 then runs `ops.vss_stage_train.
vss_stage_train` (kernel 5 forward, kernel 6 backward), as the JAX
``VSSM._fused_stage_train_path`` does.  With ``use_checkpoint`` (or a
depth-1 stage) each block runs `ops.vss_block_train.vss_block_train_op`
(kernel 4 forward, kernel 6 backward) for its SS2D half, and its MLP half
in torch, under ``torch.utils.checkpoint`` with ``use_checkpoint`` (the
``nn.remat`` counterpart).  The kernels run on the card; on the CPU their
plain versions.  `VSSBlock.forward` is the composable block (``SS2D``
module path), kept as the readable reference of what the stage computes.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from xfmamba_tpu_torch.models.layers import (
    Conv2dSame, DropPath, LayerNorm, Mlp, gelu, to_device)
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops.vss_block import (
    MLP_FIELDS, PLAIN_OPS, SS2D_FIELDS, VSSBlockOperands, mlp_half, pack_vss_block_params,
    pack_vss_block_train_params)
from xfmamba_tpu_torch.ops.vss_block_train import vss_block_train_op
from xfmamba_tpu_torch.ops.vss_stage import vss_stage
from xfmamba_tpu_torch.ops.vss_stage_train import vss_stage_train


class PatchEmbedV2(nn.Module):
    """Two stride-2 3x3 convs with LayerNorm and exact GELU between
    (``vmamba.py:2204-2219``); submodules at the reference's Sequential
    indices 0 (conv1), 2 (norm1), 5 (conv2), 7 (norm2)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 4,
                 generator=None):
        super().__init__()
        stride = patch_size // 2
        k = stride + 1
        self.add_module("0", Conv2dSame(in_chans, embed_dim // 2, k, stride, 1,
                                        generator=generator))
        self.add_module("2", LayerNorm(embed_dim // 2))
        self.add_module("5", Conv2dSame(embed_dim // 2, embed_dim, k, stride, 1,
                                        generator=generator))
        self.add_module("7", LayerNorm(embed_dim))

    def forward(self, x):
        m = self._modules
        x = gelu(m["2"](m["0"](x)))
        return m["7"](m["5"](x))


class DownsampleV3(nn.Module):
    """3x3 stride-2 conv + LayerNorm (``vmamba.py:2231-2239``); submodules
    at the reference's indices 1 (conv) and 3 (norm)."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.add_module("1", Conv2dSame(in_dim, out_dim, 3, 2, 1, generator=generator))
        self.add_module("3", LayerNorm(out_dim))

    def forward(self, x):
        return self._modules["3"](self._modules["1"](x))


class VSSBlock(nn.Module):
    """Pre-norm residual SS2D + MLP (``vmamba.py:1955-2042``), v05_noz."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 ssm_d_state: int = 1, ssm_ratio: float = 2.0,
                 ssm_dt_rank="auto", ssm_conv_bias: bool = False,
                 mlp_ratio: float = 4.0, generator=None, dropout_generator=None):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                       dt_rank=ssm_dt_rank, conv_bias=ssm_conv_bias,
                       generator=generator)
        self.drop_path = DropPath(drop_path, dropout_generator)
        self.norm2 = LayerNorm(hidden_dim) if mlp_ratio > 0 else None
        self.mlp = (Mlp(hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim,
                        generator=generator) if mlp_ratio > 0 else None)

    def forward(self, x):
        x = x + self.drop_path(self.op(self.norm(x)))
        if self.mlp is not None:
            x = x + self.drop_path(self.mlp(self.norm2(x)))
        return x


class VSSStage(nn.Module):
    """``layers.{i}``: the blocks of a stage and the downsample after it."""

    def __init__(self, blocks: Sequence[VSSBlock], downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class VSSM(nn.Module):
    """Four-stage hierarchical backbone returning the LayerNorm'd features
    of the stages in ``out_indices`` (``fusion_vmamba.py:1653-1724``).

    Only the configuration XFMamba ships is ported: patch embed v2,
    downsample v3, v05_noz blocks with d_state 1 and an MLP."""

    def __init__(self, depths=(2, 2, 9, 2), dims=96, in_chans: int = 3,
                 patch_size: int = 4, ssm_d_state: int = 1,
                 ssm_ratio: float = 2.0, ssm_dt_rank="auto",
                 ssm_conv_bias: bool = False, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2, out_indices=(0, 1, 2, 3),
                 use_checkpoint: bool = False, generator=None, dropout_generator=None):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        dims = [dims * 2 ** i for i in range(len(depths))] if isinstance(dims, int) else list(dims)
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        n_blocks = sum(depths)
        dpr = [drop_path_rate * i / max(n_blocks - 1, 1) for i in range(n_blocks)]
        self.patch_embed = PatchEmbedV2(in_chans, dims[0], patch_size, generator)
        layers = []
        for i, depth in enumerate(depths):
            blocks = [VSSBlock(dims[i], dpr[sum(depths[:i]) + j], ssm_d_state,
                               ssm_ratio, ssm_dt_rank, ssm_conv_bias, mlp_ratio,
                               generator=generator, dropout_generator=dropout_generator)
                      for j in range(depth)]
            down = (DownsampleV3(dims[i], dims[i + 1], generator)
                    if i < len(depths) - 1 else None)
            layers.append(VSSStage(blocks, down))
        self.layers = nn.ModuleList(layers)
        for i in self.out_indices:
            self.add_module(f"outnorm{i}", LayerNorm(dims[i]))

    def _drop_path_scales(self, batch, device):
        """Per stage, (depth, 2, batch) float32: each block's two drop-path
        scales, drawn on the CPU in block order and copied in one transfer."""
        scales = torch.stack([torch.stack([blk.drop_path.scales(batch) for _ in range(2)])
                              for layer in self.layers for blk in layer.blocks])
        return to_device(scales, device).split(self.depths)

    def _train_stage(self, x, layer, scales):
        """One stage in training mode on x (B, H, W, d) with its blocks'
        drop-path ``scales`` (depth, 2, B); see the module docstring."""
        B, H, W, d = x.shape
        blocks = layer.blocks
        packed = [pack_vss_block_train_params(blk, x.dtype) for blk in blocks]
        xl = x.reshape(B, H * W, d).contiguous()
        if len(blocks) >= 2 and not self.use_checkpoint:
            m1, m2 = scales[:, 0].contiguous(), scales[:, 1].contiguous()
            return vss_stage_train(xl, packed, H, W, m1, m2).reshape(B, H, W, d)
        for p, (m1, m2) in zip(packed, scales):
            xl = vss_block_train_op(xl, p, H, W, m1)
            mlp = [getattr(p, n) for n in MLP_FIELDS]
            if self.use_checkpoint:
                xl = checkpoint(_mlp_half_train, xl, m2, *mlp, use_reentrant=False)
            else:
                xl = _mlp_half_train(xl, m2, *mlp)
        return xl.reshape(B, H, W, d)

    def forward(self, x):
        """x (B, H, W, in_chans) -> list of (B, H_i, W_i, dims[i]) features."""
        scales = self._drop_path_scales(x.shape[0], x.device) if self.training else None
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            B, H, W, d = x.shape
            if self.training:
                x = self._train_stage(x, layer, scales[i])
            else:
                packed = [pack_vss_block_params(blk, x.dtype) for blk in layer.blocks]
                x = vss_stage(x.reshape(B, H * W, d).contiguous(), packed, H, W).reshape(B, H, W, d)
            if i in self.out_indices:
                outs.append(self._modules[f"outnorm{i}"](x))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


def _mlp_half_train(x, m2, *mlp):
    """A block's MLP half in torch, on the autograd graph."""
    p = VSSBlockOperands(*(None,) * len(SS2D_FIELDS), *mlp)
    return mlp_half(x, p, PLAIN_OPS, m2)
