"""Image sampling and resizing (counterpart of dvmvs_tpu/ops/sampling.py).

The JAX package re-implements two torch primitives; here they are the
primitives themselves. Layout is NCHW; grids are (B, Ho, Wo, 2) in (x, y)
order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                align_corners: bool = True) -> torch.Tensor:
    """``F.grid_sample`` with zeros padding: image (B, C, H, W), grid
    (B, Ho, Wo, 2) normalised coordinates -> (B, C, Ho, Wo)."""
    return F.grid_sample(image, grid, mode=mode, padding_mode="zeros",
                         align_corners=align_corners)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int,
                                  align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (out_h, out_w)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize (src = floor(i * in / out)) of (B, C, H, W) or (B, H, W)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    if x.dim() == 3:
        return F.interpolate(x[:, None], size=(out_h, out_w), mode="nearest")[:, 0]
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")
