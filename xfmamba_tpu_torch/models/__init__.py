"""Modules of the XFMamba model (port of ``xfmamba_tpu.models``)."""
