"""Geometry on the device: rotations, Kabsch alignment, torsion updates."""

import torch


def use_full_fp32() -> None:
    """Run float32 matrix products and convolutions in full float32 (no
    TF32) — the GPU form of the JAX package's ``Precision.HIGHEST`` rule for
    geometry. TF32 keeps ~3 decimal digits and visibly distorts poses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
