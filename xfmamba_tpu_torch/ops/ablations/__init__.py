"""The port of ``xfmamba_tpu/ops/ablations``: kernels that the JAX package
keeps behind switches, each with the switch's default.

- `nk_scan_v4` (kernel 17, ``FUSED_V4 = False``) and `nk_scan_wide` (kernel
  18, its switch ``FUSED_V3 = False`` in ``ops/nk_scan.py``): alternative
  schedules of the fusion-op nk scan, taken by ``ops/nk_scan.py::nk_scan``
  where their switches are on and their gates hold.
- `pe_fused` (kernel 19, ``PE_FUSED = False``): per-pixel LayerNorm with an
  optional GELU for the patch embed.
- `seg_ln` (kernels 20 and 21, ``SEG_LN = True``): the segment-packed
  LayerNorm(+GELU) and its backward, a differentiable op.

No model calls kernels 19-21; JAX's A/B scripts build the patch embed from
them, and ``chip_smoke.py`` does the same on the card.  The JAX module
``row_seg`` has no kernel of its own and no counterpart here.
"""
