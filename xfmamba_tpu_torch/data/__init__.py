"""The host data path (port of ``xfmamba_tpu.data``): PNG decoding, the
transforms, the prefetching loader and the MURA tables and split."""

from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
from xfmamba_tpu_torch.data.transforms import TwoViewTransform

__all__ = ["TwoViewLoader", "TwoViewSamples", "TwoViewTransform"]
