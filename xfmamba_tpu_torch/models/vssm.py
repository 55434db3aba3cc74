"""VSSM backbone in backbone mode (port of ``xfmamba_tpu/models/vssm.py``):
PatchEmbedV2, DownsampleV3, VSSBlock and VSSM with ``out_indices``.

Module and parameter names follow the reference PyTorch state dict
(``patch_embed.{0,2,5,7}``, ``layers.{i}.blocks.{j}``,
``layers.{i}.downsample.{1,3}``, ``outnorm{i}``), so a port ``state_dict()``
converts with ``xfmamba_tpu.checkpoint.convert.convert_vssm_state_dict``.

The stage loop runs each stage through `ops.vss_stage.vss_stage`: the stage
kernel on the card, the plain stage on the CPU.  `VSSBlock.forward` is the
composable block (``SS2D`` module path), kept as the readable reference of
what the stage computes.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from xfmamba_tpu_torch.models.layers import (
    Conv2dSame, DropPath, LayerNorm, Mlp, gelu)
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params
from xfmamba_tpu_torch.ops.vss_stage import vss_stage


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
                 mlp_ratio: float = 4.0, generator=None):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                       dt_rank=ssm_dt_rank, conv_bias=ssm_conv_bias,
                       generator=generator)
        self.drop_path = DropPath(drop_path)
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
                 generator=None):
        super().__init__()
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
                               generator=generator)
                      for j in range(depth)]
            down = (DownsampleV3(dims[i], dims[i + 1], generator)
                    if i < len(depths) - 1 else None)
            layers.append(VSSStage(blocks, down))
        self.layers = nn.ModuleList(layers)
        for i in self.out_indices:
            self.add_module(f"outnorm{i}", LayerNorm(dims[i]))

    def forward(self, x):
        """x (B, H, W, in_chans) -> list of (B, H_i, W_i, dims[i]) features."""
        if self.training:
            raise RuntimeError("the port runs inference only: call .eval() first")
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            B, H, W, d = x.shape
            packed = [pack_vss_block_params(blk, x.dtype) for blk in layer.blocks]
            x = vss_stage(x.reshape(B, H * W, d).contiguous(), packed, H, W).reshape(B, H, W, d)
            if i in self.out_indices:
                outs.append(self._modules[f"outnorm{i}"](x))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
