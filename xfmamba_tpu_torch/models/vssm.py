"""VSSM (port of ``xfmamba_tpu/models/vssm.py``): PatchEmbedV1,
PatchEmbedV2, DownsampleV2, DownsampleV3 (and ``models/layers.py``'s
PatchMerging2D, downsample v1), VSSBlock and VSSM, in backbone mode
(``out_indices``: the LayerNorm'd features of those stages) or in
classifier mode (``out_indices=None``: LayerNorm, mean over the map, linear
head), and the model factories: the vanilla VMamba classifiers
`vanilla_vmamba_tiny`, `vanilla_vmamba_small` and `vanilla_vmamba_base`
(forward type v0, d_state 16, no MLP, PatchEmbedV1, PatchMerging2D; their
d_state-16 cores run the nk pair, kernels 2 and 7, where the routing rule
gives a group, else kernels 13 and 14); the Mamba-2 classifiers
`vmamba_tiny_m2`, `vmamba_small_m2` and `vmamba_base_m2` (forward type
``m0_noz``, d_state 64, GELU, whose SS2D runs the SSD kernels 15 and 16);
the v05_noz classifiers
`vmamba_{tiny_s2l5,small_s2l15,base_s2l15,tiny_s1l8,small_s1l20,base_s1l20}`
(d_state 1, the backbone kernels of XFMamba), `build_model` and
`single_channel_feature_extract_mamba` (both VMamba-S s2l15), and the
feature-pyramid `backbone_vssm`.

Module and parameter names follow the reference PyTorch state dict
(``patch_embed.{0,2}`` or ``patch_embed.{0,2,5,7}``, ``layers.{i}.blocks.{j}``,
``layers.{i}.downsample.{1,3}`` or ``.{norm,reduction}``, ``outnorm{i}``, ``classifier.norm``,
``classifier.head``), so a port ``state_dict()`` converts with
``xfmamba_tpu.checkpoint.convert.convert_vssm_state_dict``.

A backbone of the configuration the stage kernels compute (XFMamba's:
forward type v05_noz, d_state 1, SiLU, the 3 x 3 conv and the GELU MLP)
dispatches on the activation dtype as the JAX
``VSSM`` does on an accelerator (`stage_kernels_apply`, `_uses_stage_route`);
any other configuration, the m2 models included, takes the composable
route in both dtypes:

- bfloat16, the stage route.  In eval mode each stage takes the kernels
  that the JAX accelerator path picks by its VMEM rule
  (`ops.vss_stage.stage_route`, `VSSM._eval_stage`): `ops.vss_stage.
  vss_stage` (kernel 1) where the v2 kernels find an image group aligned to
  8 sublanes; else, block by block, `ops.vss_block_v1.vss_block_v1`
  (kernel 8), or the composable blocks where JAX runs no whole-block
  kernel.  At one or two studies per batch XFMamba-S's stages 2 and 3 take
  kernel 8.  In training mode
  `VSSM._train_stage` packs the operands on the autograd graph, and a stage
  of depth >= 2 then runs `ops.vss_stage_train.vss_stage_train` (kernel 5
  forward, kernel 6 backward), as the JAX ``VSSM._fused_stage_train_path``
  does.  With ``use_checkpoint`` (or a depth-1 stage) each block runs
  `ops.vss_block_train.vss_block_train_op` (kernel 4 forward, kernel 6
  backward) for its SS2D half, and its MLP half in torch, under
  ``torch.utils.checkpoint`` with ``use_checkpoint``.
- float32 (every JAX CLI's default, which never takes the megakernels),
  the composable route: each block runs `VSSBlock.forward`, LayerNorm, the
  ``SS2D`` module (its N=1 core is kernel 11 forward and kernel 12
  backward, ``ops/ss2d_core_n1.py``), the residual and the MLP half, all
  other products in torch; with ``use_checkpoint`` each block runs under
  ``torch.utils.checkpoint`` (the ``nn.remat(VSSBlock)`` counterpart).

In training mode every block's two drop-path scales (SS2D half, then MLP
half) are drawn from the model's dropout generator before the step's first
launch and copied to the device at once (`VSSM._drop_path_scales`), on
both routes, so both draw the same masks.  The kernels run on the card; on
the CPU their plain versions.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from xfmamba_tpu_torch.models.layers import (
    Conv2dSame, Dense, DropPath, LayerNorm, Mlp, PatchMerging2D, gelu, to_device)
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops.primitives import forward_only
from xfmamba_tpu_torch.ops.vss_block import (
    MLP_FIELDS, PLAIN_OPS, SS2D_FIELDS, VSSBlockOperands, mlp_half, pack_vss_block_params,
    pack_vss_block_train_params)
from xfmamba_tpu_torch.ops.vss_block_train import vss_block_train_op
from xfmamba_tpu_torch.ops.vss_block_v1 import pack_vss_block_v1_params, vss_block_v1
from xfmamba_tpu_torch.ops.vss_stage import stage_route, vss_stage
from xfmamba_tpu_torch.ops.vss_stage_train import vss_stage_train


class PatchEmbedV1(nn.Module):
    """One stride-4 4x4 conv and LayerNorm (``vmamba.py:2196-2202``;
    JAX ``PatchEmbedV1``, ``vssm.py:45``); submodules at the reference's
    Sequential indices 0 (proj) and 2 (norm)."""

    JAX_NAMES = {"0": "proj", "2": "norm"}

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 4,
                 generator=None):
        super().__init__()
        self.add_module("0", Conv2dSame(in_chans, embed_dim, patch_size, patch_size,
                                        generator=generator))
        self.add_module("2", LayerNorm(embed_dim))

    def forward(self, x):
        return self._modules["2"](self._modules["0"](x))


class PatchEmbedV2(nn.Module):
    """Two stride-2 3x3 convs with LayerNorm and exact GELU between
    (``vmamba.py:2204-2219``); submodules at the reference's Sequential
    indices 0 (conv1), 2 (norm1), 5 (conv2), 7 (norm2)."""

    JAX_NAMES = {"0": "conv1", "2": "norm1", "5": "conv2", "7": "norm2"}

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

    JAX_NAMES = {"1": "conv", "3": "norm"}
    KERNEL, PADDING = 3, 1

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.add_module("1", Conv2dSame(in_dim, out_dim, self.KERNEL, 2, self.PADDING,
                                        generator=generator))
        self.add_module("3", LayerNorm(out_dim))

    def forward(self, x):
        return self._modules["3"](self._modules["1"](x))


class DownsampleV2(DownsampleV3):
    """2x2 stride-2 conv + LayerNorm (``vmamba.py:2221-2229``; JAX
    ``DownsampleV2``, ``vssm.py:95``), the reference's indices 1 and 3."""

    KERNEL, PADDING = 2, 0


class VSSBlock(nn.Module):
    """Pre-norm residual SS2D + MLP (``vmamba.py:1955-2042``); no MLP half
    (no ``norm2``, no ``mlp``) where ``mlp_ratio`` is 0."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 ssm_d_state: int = 1, ssm_ratio: float = 2.0,
                 ssm_dt_rank="auto", ssm_conv_bias: bool = False,
                 mlp_ratio: float = 4.0, generator=None, dropout_generator=None,
                 forward_type: str = "v05_noz", ssm_act: str = "silu", ssm_init: str = "v0",
                 ssm_conv: int = 3):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                       dt_rank=ssm_dt_rank, d_conv=ssm_conv, conv_bias=ssm_conv_bias,
                       forward_type=forward_type, act=ssm_act, initialize=ssm_init,
                       generator=generator)
        self.drop_path = DropPath(drop_path, dropout_generator)
        self.norm2 = LayerNorm(hidden_dim) if mlp_ratio > 0 else None
        self.mlp = (Mlp(hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim,
                        generator=generator) if mlp_ratio > 0 else None)

    def forward(self, x, scales=None):
        """x (B, H, W, d).  ``scales`` (2, B) float32 are the drop-path
        scales of the two halves, drawn by the caller; without them the
        block's DropPath draws its own."""
        def drop(h, i):
            if scales is None:
                return self.drop_path(h)
            return h * scales[i].to(h.dtype).view(-1, 1, 1, 1)

        x = x + drop(self.op(self.norm(x)), 0)
        if self.mlp is not None:
            x = x + drop(self.mlp(self.norm2(x)), 1)
        return x


class VSSStage(nn.Module):
    """``layers.{i}``: the blocks of a stage and the downsample after it."""

    def __init__(self, blocks: Sequence[VSSBlock], downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class Classifier(nn.Module):
    """``classifier``: LayerNorm, the mean over the map, the linear head
    (``vssm.py:486-491``)."""

    def __init__(self, dim: int, num_classes: int, generator=None):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.head = Dense(dim, num_classes, init="trunc_normal", generator=generator)

    def forward(self, x):
        return self.head(self.norm(x).mean((1, 2)))


def _packed(block, dtype, pack, cache):
    """``pack(block, dtype)``, the kernel operands of an inference block:
    packed anew at every forward unless ``cache`` (a dict, from
    `VSSM.pack_for_inference`) keeps them, and then only while the block's
    parameters keep their storage and version counters."""
    if cache is None:
        return pack(block, dtype)
    key = (pack, dtype, tuple((t.data_ptr(), t._version) for t in block.parameters()))
    hit = cache.get(id(block))
    if hit is None or hit[0] != key:
        hit = cache[id(block)] = (key, pack(block, dtype))
    return hit[1]


class VSSM(nn.Module):
    """Four-stage hierarchical VSSM: with ``out_indices`` the LayerNorm'd
    features of those stages (``fusion_vmamba.py:1653-1724``), with
    ``out_indices=None`` the logits of the classifier (``vssm.py:483-492``).

    ``patchembed_version`` "v1" (`PatchEmbedV1`) or "v2" (`PatchEmbedV2`);
    ``downsample_version`` "v1" (`PatchMerging2D`), "v2" (`DownsampleV2`),
    "v3" (`DownsampleV3`) or "none"; blocks of any SS2D forward type with
    a depthwise conv of ``ssm_conv`` and a GELU MLP of ``mlp_ratio``, none
    where it is 0."""

    PATCH_EMBEDS = {"v1": PatchEmbedV1, "v2": PatchEmbedV2}
    DOWNSAMPLES = {"v1": PatchMerging2D, "v2": DownsampleV2, "v3": DownsampleV3}

    def __init__(self, depths=(2, 2, 9, 2), dims=96, in_chans: int = 3,
                 patch_size: int = 4, ssm_d_state: int = 1,
                 ssm_ratio: float = 2.0, ssm_dt_rank="auto",
                 ssm_conv_bias: bool = False, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2, out_indices=(0, 1, 2, 3),
                 use_checkpoint: bool = False, generator=None, dropout_generator=None,
                 forward_type: str = "v05_noz", ssm_act: str = "silu", ssm_init: str = "v0",
                 num_classes: int = 1000, ssm_conv: int = 3, patchembed_version: str = "v2",
                 downsample_version: str = "v3"):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self._operands = None      # the inference blocks' packed operands (pack_for_inference)
        dims = [dims * 2 ** i for i in range(len(depths))] if isinstance(dims, int) else list(dims)
        self.depths = tuple(depths)
        self.out_indices = None if out_indices is None else tuple(out_indices)
        self.stage_kernels = stage_kernels_apply(forward_type, ssm_d_state, ssm_act, ssm_conv,
                                                 mlp_ratio)
        n_blocks = sum(depths)
        dpr = [drop_path_rate * i / max(n_blocks - 1, 1) for i in range(n_blocks)]
        if downsample_version not in self.DOWNSAMPLES and downsample_version != "none":
            raise ValueError(f"unknown downsample_version {downsample_version!r}")
        self.patch_embed = self.PATCH_EMBEDS[patchembed_version](in_chans, dims[0], patch_size,
                                                                  generator)
        layers = []
        for i, depth in enumerate(depths):
            blocks = [VSSBlock(dims[i], dpr[sum(depths[:i]) + j], ssm_d_state,
                               ssm_ratio, ssm_dt_rank, ssm_conv_bias, mlp_ratio,
                               generator=generator, dropout_generator=dropout_generator,
                               forward_type=forward_type, ssm_act=ssm_act, ssm_init=ssm_init,
                               ssm_conv=ssm_conv)
                      for j in range(depth)]
            down = (self.DOWNSAMPLES[downsample_version](dims[i], dims[i + 1],
                                                         generator=generator)
                    if i < len(depths) - 1 and downsample_version != "none" else None)
            layers.append(VSSStage(blocks, down))
        self.layers = nn.ModuleList(layers)
        if self.out_indices is None:
            self.classifier = Classifier(dims[-1], num_classes, generator)
        else:
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

    def pack_for_inference(self):
        """Keep each inference block's packed kernel operands from the next
        eval forward on, instead of packing them at every forward.  Call it
        once the weights are final: ``train()`` (training mode; ``eval()``
        changes no weight and keeps them), `load_state_dict` and a move
        (``.to``, ``.cuda``) drop the operands and end the keeping, but an
        in-place write through ``.data`` is not seen."""
        self._operands = {}
        return self

    def train(self, mode: bool = True):
        if mode:
            self._operands = None
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._operands = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._operands = None
        return super()._load_from_state_dict(*args, **kwargs)

    def _eval_stage(self, x, layer):
        """One stage in eval mode on the stage route, x (B, H, W, d): kernel
        1, kernel 8 block by block, or the composable blocks, as
        `stage_route` decides."""
        B, H, W, d = x.shape
        blk = layer.blocks[0]
        route = stage_route(B, H, W, d, blk.op.d_inner, blk.mlp.fc1.weight.shape[0],
                            len(layer.blocks))
        if route == "composable":
            return self._block_stage(x, layer, None)
        if x.is_cuda and torch.is_grad_enabled():
            # the kernels have no backward and take operands packed without
            # a graph: refuse a forward that autograd records (tested before
            # the parameters are gathered, so a forward without grad pays
            # nothing)
            forward_only("the eval stage kernels", x, *layer.parameters())
        xl = x.reshape(B, H * W, d).contiguous()
        if route == "stage":
            packed = [_packed(b, x.dtype, pack_vss_block_params, self._operands)
                      for b in layer.blocks]
            return vss_stage(xl, packed, H, W).reshape(B, H, W, d)
        for b in layer.blocks:
            xl = vss_block_v1(xl, _packed(b, x.dtype, pack_vss_block_v1_params, self._operands),
                              H, W)
        return xl.reshape(B, H, W, d)

    def _block_stage(self, x, layer, scales):
        """One stage on the composable route: block by block, each under
        ``torch.utils.checkpoint`` with ``use_checkpoint`` in training."""
        for j, blk in enumerate(layer.blocks):
            s = None if scales is None else scales[j]
            if self.training and self.use_checkpoint:
                x = checkpoint(blk, x, s, use_reentrant=False)
            else:
                x = blk(x, s)
        return x

    def forward(self, x):
        """x (B, H, W, in_chans) -> list of (B, H_i, W_i, dims[i]) features,
        or (B, num_classes) logits in classifier mode."""
        scales = self._drop_path_scales(x.shape[0], x.device) if self.training else None
        x = self.patch_embed(x)
        kernels = self.stage_kernels and _uses_stage_route(x.dtype)
        outs = []
        for i, layer in enumerate(self.layers):
            if not kernels:
                x = self._block_stage(x, layer, None if scales is None else scales[i])
            elif self.training:
                x = self._train_stage(x, layer, scales[i])
            else:
                x = self._eval_stage(x, layer)
            if self.out_indices is not None and i in self.out_indices:
                outs.append(self._modules[f"outnorm{i}"](x))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs if self.out_indices is not None else self.classifier(x)


def stage_kernels_apply(forward_type: str, d_state: int, ssm_act: str, ssm_conv: int = 3,
                        mlp_ratio: float = 4.0) -> bool:
    """Whether the stage kernels compute this backbone's blocks: JAX's
    conditions for its megakernel paths (``vssm.py:149-153, :192-197,
    :322-327, :364-370``), forward type v05_noz, d_state 1, SiLU and the
    3 x 3 conv; the port's blocks have no gated MLP and a GELU MLP, the
    conditions' other terms.  The port's stage kernels also need the MLP
    half (JAX's kernels drop it where ``mlp_ratio`` is 0): a block without
    one runs the composable route.  Every other forward type (vanilla
    VMamba's v0 among them) runs block by block in both dtypes."""
    return (forward_type == "v05_noz" and d_state == 1 and ssm_act == "silu" and ssm_conv == 3
            and mlp_ratio > 0)


def _uses_stage_route(dtype) -> bool:
    """The stage kernels run in bfloat16 only, as the JAX megakernel paths
    require ``dtype == bfloat16`` (``vssm.py:152, :195, :325, :367``)."""
    return dtype == torch.bfloat16


def _mlp_half_train(x, m2, *mlp):
    """A block's MLP half in torch, on the autograd graph."""
    p = VSSBlockOperands(*(None,) * len(SS2D_FIELDS), *mlp)
    return mlp_half(x, p, PLAIN_OPS, m2)


# ---------------------------------------------------------------------------
# the model factories (``vssm.py:495-595``)
# ---------------------------------------------------------------------------

def _vssm(num_classes, device, seed, **cfg) -> VSSM:
    """A classifier VSSM, weights from a ``torch.Generator`` seeded with
    ``seed`` and drop-path masks from one seeded with ``seed + 1`` (unless
    ``cfg`` gives the generators), in eval mode on ``device`` (the card
    unless the caller asks for the CPU)."""
    cfg = dict(generator=torch.Generator().manual_seed(seed),
               dropout_generator=torch.Generator().manual_seed(seed + 1)) | cfg
    model = VSSM(num_classes=num_classes, **(dict(out_indices=None) | cfg))
    return model.eval().to(device)


# what the three m2 models share (``vssm.py:571-585``)
_M2 = dict(ssm_d_state=64, ssm_ratio=1.0, ssm_act="gelu", ssm_conv_bias=False, ssm_init="v2",
           forward_type="m0_noz", mlp_ratio=4.0)


def vmamba_tiny_m2(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """Mamba-2 (SSD) VMamba-T: depths 2/2/4/2, dims 96, d_state 64, GELU,
    m0_noz, ssm_init v2; ``kw`` overrides any VSSM argument."""
    cfg = dict(depths=(2, 2, 4, 2), dims=96, drop_path_rate=0.2)
    return _vssm(num_classes, device, seed, **(_M2 | cfg | kw))


def vmamba_small_m2(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """Mamba-2 VMamba-S: depths 2/2/12/2, dims 96."""
    cfg = dict(depths=(2, 2, 12, 2), dims=96, drop_path_rate=0.3)
    return _vssm(num_classes, device, seed, **(_M2 | cfg | kw))


def vmamba_base_m2(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """Mamba-2 VMamba-B: depths 2/2/12/2, dims 128."""
    cfg = dict(depths=(2, 2, 12, 2), dims=128, drop_path_rate=0.3)
    return _vssm(num_classes, device, seed, **(_M2 | cfg | kw))


# what the v05_noz factories share (``vssm.py:541-569``): d_state 1, SiLU,
# no conv bias, the GELU MLP of ratio 4, downsample v3, patch embed v2
_V05 = dict(ssm_d_state=1, ssm_act="silu", ssm_conv_bias=False, ssm_init="v0",
            forward_type="v05_noz", mlp_ratio=4.0)


def vmamba_tiny_s2l5(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """VMamba-T s2l5: depths 2/2/5/2, dims 96, ssm_ratio 2; ``kw``
    overrides any VSSM argument."""
    cfg = dict(depths=(2, 2, 5, 2), dims=96, drop_path_rate=0.2, ssm_ratio=2.0)
    return _vssm(num_classes, device, seed, **(_V05 | cfg | kw))


def vmamba_small_s2l15(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """VMamba-S s2l15: depths 2/2/15/2, dims 96, ssm_ratio 2 (XFMamba-S's
    backbone geometry)."""
    cfg = dict(depths=(2, 2, 15, 2), dims=96, drop_path_rate=0.3, ssm_ratio=2.0)
    return _vssm(num_classes, device, seed, **(_V05 | cfg | kw))


def vmamba_base_s2l15(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """VMamba-B s2l15: depths 2/2/15/2, dims 128, ssm_ratio 2."""
    cfg = dict(depths=(2, 2, 15, 2), dims=128, drop_path_rate=0.6, ssm_ratio=2.0)
    return _vssm(num_classes, device, seed, **(_V05 | cfg | kw))


def vmamba_tiny_s1l8(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """VMamba-T s1l8: depths 2/2/8/2, dims 96, ssm_ratio 1 (d_inner = d,
    XFMamba-T's backbone geometry)."""
    cfg = dict(depths=(2, 2, 8, 2), dims=96, drop_path_rate=0.2, ssm_ratio=1.0)
    return _vssm(num_classes, device, seed, **(_V05 | cfg | kw))


def vmamba_small_s1l20(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """VMamba-S s1l20: depths 2/2/20/2, dims 96, ssm_ratio 1."""
    cfg = dict(depths=(2, 2, 20, 2), dims=96, drop_path_rate=0.3, ssm_ratio=1.0)
    return _vssm(num_classes, device, seed, **(_V05 | cfg | kw))


def vmamba_base_s1l20(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """VMamba-B s1l20: depths 2/2/20/2, dims 128, ssm_ratio 1."""
    cfg = dict(depths=(2, 2, 20, 2), dims=128, drop_path_rate=0.5, ssm_ratio=1.0)
    return _vssm(num_classes, device, seed, **(_V05 | cfg | kw))


# what the vanilla VMamba classifiers share (``vssm.py:526-538``; the v0
# configurations of arXiv 2401.10166): forward type v0 (a SiLU z-gate, the
# LayerNorm out-norm, the cross2d scan), d_state 16, ssm_ratio 2, the conv
# bias, no MLP, PatchEmbedV1 and PatchMerging2D
_VANILLA = dict(ssm_d_state=16, ssm_ratio=2.0, ssm_act="silu", ssm_conv_bias=True, ssm_init="v0",
                forward_type="v0", mlp_ratio=0.0, patchembed_version="v1",
                downsample_version="v1")


def vanilla_vmamba_tiny(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """Vanilla VMamba-T: depths 2/2/9/2, dims 96; ``kw`` overrides any VSSM
    argument."""
    cfg = dict(depths=(2, 2, 9, 2), dims=96, drop_path_rate=0.2)
    return _vssm(num_classes, device, seed, **(_VANILLA | cfg | kw))


def vanilla_vmamba_small(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """Vanilla VMamba-S: depths 2/2/27/2, dims 96."""
    cfg = dict(depths=(2, 2, 27, 2), dims=96, drop_path_rate=0.3)
    return _vssm(num_classes, device, seed, **(_VANILLA | cfg | kw))


def vanilla_vmamba_base(num_classes=1000, *, device="cuda", seed=0, **kw) -> VSSM:
    """Vanilla VMamba-B: depths 2/2/27/2, dims 128."""
    cfg = dict(depths=(2, 2, 27, 2), dims=128, drop_path_rate=0.6)
    return _vssm(num_classes, device, seed, **(_VANILLA | cfg | kw))


def build_model(num_classes=1000, **kw) -> VSSM:
    """The default classifier, VMamba-S s2l15 (``models/__init__.py:50-53``
    of the reference); ``kw`` as `vmamba_small_s2l15`'s."""
    return vmamba_small_s2l15(num_classes=num_classes, **kw)


def single_channel_feature_extract_mamba(num_classes=2, **kw) -> VSSM:
    """``fusion_vmamba.py:1728-1739``: VMamba-S s2l15."""
    return vmamba_small_s2l15(num_classes=num_classes, **kw)


def backbone_vssm(depths=(2, 2, 15, 2), dims=96, drop_path_rate=0.3, ssm_ratio=2.0,
                  out_indices=(0, 1, 2, 3), *, device="cuda", seed=0, **kw) -> VSSM:
    """The feature-pyramid backbone with XFMamba's defaults
    (``fusion_vmamba.py:1653-1663``: VMamba-S geometry, d_state 1, v05_noz):
    the LayerNorm'd features of the stages in ``out_indices``.  Seeded and
    placed as the classifier factories; ``kw`` overrides any VSSM
    argument."""
    cfg = dict(depths=depths, dims=dims, drop_path_rate=drop_path_rate, ssm_ratio=ssm_ratio,
               out_indices=out_indices)
    return _vssm(1000, device, seed, **(_V05 | cfg | kw))
