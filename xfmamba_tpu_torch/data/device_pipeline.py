"""The device preprocessing stage (port of
``xfmamba_tpu/data/device_pipeline.py``): the host decodes and stages
uint8 at the image size; resize, random crop, flip, nearest rotation and
normalize run on the card, one kernel launch per view per batch
(``ops/device_preprocess.py``, ``csrc/device_preprocess.cu``).

    host (loader threads): decode -> [NYU crop] -> u8 resize to the staging size
    card (one launch)    : u8 / 255 -> resize -> crop -> hflip ->
                           rotate (nearest, fill 0) -> normalize

Shipping uint8 cuts the host-to-card bytes 4x and takes the float work off
the host, where the loader's threads share the GIL with the thread that
launches the step.  CPU tensors take the kernel's plain version.

``jax.random`` draws cannot be replayed in torch, so the random parameters
are arguments: `DevicePreprocess.draw_params` draws each sample's crop
offsets, flip flag and angle from a ``torch.Generator`` with JAX's
distributions (uniform integers in [0, h - crop], Bernoulli 0.5, uniform in
±degrees), and `train_batch` takes them as rows of (top, left, flip, cos,
sin) (`ops.device_preprocess.param_rows`).  The training step draws both
views' rows from the stage's own generator (``generator``, seeded by
``seed``) before its first launch and copies them to the card in one copy
(`train.loop.make_train_step`); ``last.pt`` keeps the generator's state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from xfmamba_tpu_torch.data.transforms import resize
from xfmamba_tpu_torch.ops.device_preprocess import device_preprocess, param_rows


@dataclasses.dataclass
class DevicePreprocess:
    """The batched stage; ``seed`` seeds ``generator``, the stage's own
    generator of augmentation parameters."""
    image_size: Tuple[int, int] = (224, 224)
    crop: Optional[int] = 224
    hflip: bool = True
    rotation: float = 30.0
    normalize_mean: Optional[float] = 0.456
    normalize_std: Optional[float] = 0.224
    seed: int = 0

    def __post_init__(self):
        self.image_size = tuple(self.image_size)
        self.generator = torch.Generator().manual_seed(self.seed)

    @property
    def crop_size(self) -> Optional[int]:
        """The crop a train batch takes: ``min(crop, *image_size)``, or None
        (no crop) where it is off or the whole image."""
        if not self.crop:
            return None
        c = min(self.crop, *self.image_size)
        return None if (c, c) == self.image_size else c

    def draw_params(self, batch: int, generator: Optional[torch.Generator] = None) -> dict:
        """Per-sample ``top``, ``left`` (int64), ``flip`` (bool) and ``angle``
        (float32 degrees) on the CPU, drawn from ``generator`` (the stage's
        own by default) in that order, as JAX's stage draws them: offsets
        uniform in [0, h - crop], a flip with probability 1/2, an angle
        uniform in ±rotation; zeros for a step that is off."""
        g = self.generator if generator is None else generator
        zeros = torch.zeros(batch, dtype=torch.int64)
        top = left = zeros
        c = self.crop_size
        if c is not None:
            h, w = self.image_size
            top = torch.randint(0, h - c + 1, (batch,), generator=g)
            left = torch.randint(0, w - c + 1, (batch,), generator=g)
        flip = (torch.rand(batch, generator=g) < 0.5) if self.hflip else zeros.bool()
        angle = torch.zeros(batch)
        if self.rotation:
            angle = (torch.rand(batch, generator=g) * 2 - 1) * float(self.rotation)
        return {"top": top, "left": left, "flip": flip, "angle": angle}

    def rows(self, params: dict) -> torch.Tensor:
        """(B, 5) float32 rows of `draw_params`' dict (`param_rows`)."""
        return param_rows(params["top"], params["left"], params["flip"], params["angle"])

    def _normalize(self):
        if self.normalize_mean is None:
            return {}
        return {"mean": self.normalize_mean, "std": self.normalize_std}

    def train_batch(self, u8: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """(B, Hs, Ws, 1) uint8 -> augmented, normalized (B, h, w, 1)
        float32; ``rows`` (B, 5) as `rows` makes them, on the CPU or on
        ``u8``'s device."""
        return device_preprocess(u8, self.image_size, rows.to(u8.device), self.crop_size,
                                 bool(self.rotation), **self._normalize())

    def eval_batch(self, u8: torch.Tensor) -> torch.Tensor:
        """Deterministic resize + normalize (the eval transform)."""
        return device_preprocess(u8, self.image_size, **self._normalize())

    def __call__(self, u8, rows=None, train=True):
        if train:
            if rows is None:
                raise ValueError("a train batch needs its augmentation rows")
            return self.train_batch(u8, rows)
        return self.eval_batch(u8)


@dataclasses.dataclass
class StagingTransform:
    """Host half of the pipeline: the uint8 resize to the staging size only
    (the port's cv2-exact `data.transforms.resize`); decode and the ragged
    to fixed step stay on the host.  Output (H, W, 1) uint8."""
    image_size: Tuple[int, int] = (224, 224)

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        img = resize(img, tuple(self.image_size))
        if img.ndim == 2:
            img = img[:, :, None]
        return np.ascontiguousarray(img.astype(np.uint8))


def mura_device_preprocess(image_size=(224, 224), train=True, seed=0):
    """MURA (``dataset_mura_twoview.py:808-816``); hip X-rays take it too."""
    if train:
        return DevicePreprocess(image_size=tuple(image_size), crop=min(224, *image_size),
                                seed=seed)
    return DevicePreprocess(image_size=tuple(image_size), crop=None, hflip=False, rotation=0.0,
                            seed=seed)


def ddsm_device_preprocess(image_size=(224, 224), train=True, seed=0):
    """CBIS-DDSM: no crop, no Normalize; hflip and rotation(30) in training
    (``dataset_ddsmxray_twoview.py:676-692``).  The DICOM decode and the NYU
    crop stay on the host."""
    if train:
        return DevicePreprocess(image_size=tuple(image_size), crop=None, hflip=True,
                                rotation=30.0, normalize_mean=None, normalize_std=None,
                                seed=seed)
    return DevicePreprocess(image_size=tuple(image_size), crop=None, hflip=False, rotation=0.0,
                            normalize_mean=None, normalize_std=None, seed=seed)


def chexpert_device_preprocess(image_size=(224, 224), train=True, seed=0):
    """CheXpert: no Normalize (``dataset_chexpert_twoview.py:295``)."""
    if train:
        return DevicePreprocess(image_size=tuple(image_size), crop=min(224, *image_size),
                                normalize_mean=None, normalize_std=None, seed=seed)
    return DevicePreprocess(image_size=tuple(image_size), crop=None, hflip=False, rotation=0.0,
                            normalize_mean=None, normalize_std=None, seed=seed)
