"""The host data path (port of ``xfmamba_tpu.data``): PNG and JPEG decoding
by content, the DICOM reader, the transforms, the prefetching loader, and
the MURA, CheXpert, hip X-ray and CBIS-DDSM tables, splits and loaders (with
the NYU breast crop)."""

from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
from xfmamba_tpu_torch.data.transforms import TwoViewTransform

__all__ = ["TwoViewLoader", "TwoViewSamples", "TwoViewTransform"]
