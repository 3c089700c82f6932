"""Prediction panels as PNG files (counterpart of
dvmvs_tpu/utils/visualization.py; reference: dvmvs/utils.py:355-366).

``save_visualization`` writes, per keyframe, the denormalised reference and
measurement frames, the depth times ``depth_multiplier`` as uint16, and the
depth coloured with OpenCV's turbo map: the four PNGs the JAX package writes
on a host without a display. The turbo map is OpenCV's own 256-level table,
kept as data (``turbo_colormap.txt``). The JAX package's live OpenCV windows
(``visualize_predictions``, ``display_available``) are not ported: the port
runs without OpenCV and a display.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np

from dvmvs_tpu_torch.data.io import write_png

VIS_DIR = "visualizations"  # where the drivers write, as the JAX drivers do
TURBO_TABLE = Path(__file__).with_name("turbo_colormap.txt")


@functools.lru_cache(maxsize=1)
def turbo_rgb() -> np.ndarray:
    """(256, 3) uint8: the RGB colour of each level of OpenCV's
    ``COLORMAP_TURBO``."""
    table = np.loadtxt(TURBO_TABLE, dtype=np.uint8)
    if table.shape != (256, 3):
        raise ValueError(f"{TURBO_TABLE}: want 256 rows of RGB, got {table.shape}")
    return table


def denormalize_image(image: np.ndarray, mean_rgb, std_rgb, scale_rgb: float) -> np.ndarray:
    img = image * np.array(std_rgb) + np.array(mean_rgb)
    return np.clip(img * scale_rgb, 0, 255).astype(np.uint8)


def colorize_depth(depth: np.ndarray, max_depth: float = 5.0) -> np.ndarray:
    """Depth (H, W) -> RGB (H, W, 3) uint8 through the turbo map, 0..max_depth
    over its 256 levels (``cv2.applyColorMap`` then BGR to RGB)."""
    d = np.clip(depth / max_depth, 0, 1)
    return turbo_rgb()[(d * 255).astype(np.uint8)]


def save_visualization(out_dir: str, index: int, reference_image: np.ndarray,
                       measurement_image: np.ndarray, predicted_depth: np.ndarray, mean_rgb,
                       std_rgb, scale_rgb: float, depth_multiplier: float = 5000.0):
    """Write ``{index:05d}_{reference,measurement,depth,depth_color}.png``
    under ``out_dir`` from the network's normalised frames (H, W, 3) and the
    predicted depth (H, W)."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, f"{index:05d}")
    write_png(f"{stem}_reference.png",
              denormalize_image(reference_image, mean_rgb, std_rgb, scale_rgb))
    write_png(f"{stem}_measurement.png",
              denormalize_image(measurement_image, mean_rgb, std_rgb, scale_rgb))
    write_png(f"{stem}_depth.png", (depth_multiplier * predicted_depth).astype(np.uint16))
    write_png(f"{stem}_depth_color.png", colorize_depth(predicted_depth))
