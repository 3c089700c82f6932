"""Image / intrinsics preprocessing (counterpart of
dvmvs_tpu/data/preprocess.py; reference: dvmvs/dataset_loader.py:271-346).

Aspect-ratio-preserving center crop (optional, with distortion margin) +
resize, with consistent intrinsics rescaling. Host-side NumPy. A crop that
already has the target size is returned as it is (``cv2.resize`` is the
identity there), so a corpus stored at the training size needs no OpenCV;
a real resize imports cv2 at call time and raises if it is missing.
"""

from __future__ import annotations

import numpy as np


def _resize(image: np.ndarray, width: int, height: int, nearest: bool) -> np.ndarray:
    if image.shape[:2] == (height, width):
        return image.copy()
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"resizing {image.shape[1]}x{image.shape[0]} frames to {width}x{height} needs "
            "OpenCV (cv2), which is not installed; store the corpus at the training size "
            "or install opencv-python") from e
    return cv2.resize(image, (width, height),
                      interpolation=cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR)


class PreprocessImage:
    def __init__(
        self,
        K: np.ndarray,
        old_width: int,
        old_height: int,
        new_width: int,
        new_height: int,
        distortion_crop: int = 0,
        perform_crop: bool = True,
    ):
        self.fx = K[0, 0]
        self.fy = K[1, 1]
        self.cx = K[0, 2]
        self.cy = K[1, 2]
        self.new_width = new_width
        self.new_height = new_height
        self.perform_crop = perform_crop

        original_height = np.copy(old_height)
        original_width = np.copy(old_width)

        if self.perform_crop:
            old_height -= 2 * distortion_crop
            old_width -= 2 * distortion_crop

            old_aspect_ratio = float(old_width) / float(old_height)
            new_aspect_ratio = float(new_width) / float(new_height)

            if old_aspect_ratio > new_aspect_ratio:
                # crop horizontally to reduce width
                target_width = old_height * new_aspect_ratio
                self.crop_x = int(np.floor((old_width - target_width) / 2.0)) + distortion_crop
                self.crop_y = distortion_crop
            else:
                # crop vertically to reduce height
                target_height = old_width / new_aspect_ratio
                self.crop_x = distortion_crop
                self.crop_y = int(np.floor((old_height - target_height) / 2.0)) + distortion_crop

            self.cx -= self.crop_x
            self.cy -= self.crop_y
            intermediate_height = original_height - 2 * self.crop_y
            intermediate_width = original_width - 2 * self.crop_x

            factor_x = float(new_width) / float(intermediate_width)
            factor_y = float(new_height) / float(intermediate_height)
        else:
            self.crop_x = 0
            self.crop_y = 0
            factor_x = float(new_width) / float(original_width)
            factor_y = float(new_height) / float(original_height)

        self.fx *= factor_x
        self.fy *= factor_y
        self.cx *= factor_x
        self.cy *= factor_y

    def apply_depth(self, depth: np.ndarray) -> np.ndarray:
        h, w = depth.shape
        cropped = depth[self.crop_y : h - self.crop_y, self.crop_x : w - self.crop_x]
        return _resize(cropped, self.new_width, self.new_height, nearest=True)

    def apply_rgb(
        self,
        image: np.ndarray,
        scale_rgb: float,
        mean_rgb,
        std_rgb,
        normalize_colors: bool = True,
    ) -> np.ndarray:
        h, w, _ = image.shape
        cropped = image[self.crop_y : h - self.crop_y, self.crop_x : w - self.crop_x, :]
        cropped = _resize(cropped, self.new_width, self.new_height, nearest=False)
        if normalize_colors:
            cropped = cropped / scale_rgb
            cropped[:, :, 0] = (cropped[:, :, 0] - mean_rgb[0]) / std_rgb[0]
            cropped[:, :, 1] = (cropped[:, :, 1] - mean_rgb[1]) / std_rgb[1]
            cropped[:, :, 2] = (cropped[:, :, 2] - mean_rgb[2]) / std_rgb[2]
        return cropped

    def get_updated_intrinsics(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=np.float64
        )
