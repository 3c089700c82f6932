"""Image / intrinsics preprocessing (counterpart of
dvmvs_tpu/data/preprocess.py; reference: dvmvs/dataset_loader.py:271-346).

Aspect-ratio-preserving center crop (optional, with distortion margin) +
resize, with consistent intrinsics rescaling. Host-side NumPy, without
OpenCV: ``resize`` reproduces ``cv2.resize`` (OpenCV 5.0 as built for pip,
with its IPP code) bit for bit, so a scene stored at any size gives the
JAX package's frames:

  - nearest (depth): source index ``floor(dst * (1 / (dst_size /
    src_size)))``, clamped to the last pixel;
  - linear on ``uint8``: OpenCV's fixed point, 11-bit coefficients, an
    integer row pass and its vectorised column pass ((S >> 4) * beta >> 16,
    then (sum + 2) >> 2);
  - linear on ``float32``: half-pixel centres, clamped edges, one
    ``fma(w, x1 - x0, x0)`` per axis, rows first, with each weight rounded
    once to float32 from its double-precision position. The only known
    departure: sources under about 25 pixels wide with 3 channels, enlarged
    about tenfold, differ by one float32 step at a few border columns.
"""

from __future__ import annotations

import numpy as np


def _nearest_index(src: int, dst: int) -> np.ndarray:
    step = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * step).astype(np.int64), src - 1)


def _linear_taps(src: int, dst: int, position_dtype):
    """Per output pixel along one axis: the two source indices and the
    weight of the second, from the half-pixel position computed in
    ``position_dtype``; past either edge both taps are the edge pixel."""
    pos = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(position_dtype)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0.astype(position_dtype)).astype(np.float32)
    outside = (i0 < 0) | (i0 >= src - 1)
    frac[outside] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), frac


def _lerp(x0: np.ndarray, x1: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float32 ``fma(w, x1 - x0, x0)``: the difference rounded to float32,
    the product and sum exact, one rounding at the end."""
    diff = (x1 - x0).astype(np.float64)
    return (x0.astype(np.float64) + w.astype(np.float64) * diff).astype(np.float32)


def _linear_float32(image: np.ndarray, width: int, height: int) -> np.ndarray:
    H, W = image.shape[:2]
    trailing = (1,) * (image.ndim - 2)
    x0, x1, wx = _linear_taps(W, width, np.float64)
    y0, y1, wy = _linear_taps(H, height, np.float64)
    rows = _lerp(image[:, x0], image[:, x1], wx.reshape((1, -1) + trailing))
    return _lerp(rows[y0], rows[y1], wy.reshape((-1, 1) + trailing))


def _fixed_coefficients(frac: np.ndarray) -> tuple:
    """float32 weights -> OpenCV's 11-bit integer pair (1 - f, f)."""
    scale = np.float32(2048.0)
    return (np.rint((np.float32(1.0) - frac) * scale).astype(np.int64),
            np.rint(frac * scale).astype(np.int64))


def _linear_uint8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    H, W = image.shape[:2]
    trailing = (1,) * (image.ndim - 2)
    x0, x1, fx = _linear_taps(W, width, np.float32)
    a0, a1 = _fixed_coefficients(fx)
    src = image.astype(np.int64)
    rows = (src[:, x0] * a0.reshape((1, -1) + trailing)
            + src[:, x1] * a1.reshape((1, -1) + trailing))
    # rows: unlike columns, the weights are not clamped at the edges (the
    # clamped row indices make both taps the edge row)
    pos = ((np.arange(height) + 0.5) * (1.0 / (height / H)) - 0.5).astype(np.float32)
    y = np.floor(pos).astype(np.int64)
    b0, b1 = _fixed_coefficients((pos - y.astype(np.float32)).astype(np.float32))
    b0, b1 = b0.reshape((-1, 1) + trailing), b1.reshape((-1, 1) + trailing)
    top, bottom = rows[np.clip(y, 0, H - 1)], rows[np.clip(y + 1, 0, H - 1)]
    # the vectorised column pass: int16 lanes, high halves of the products
    t0 = np.clip(top >> 4, -32768, 32767)
    t1 = np.clip(bottom >> 4, -32768, 32767)
    total = np.clip(((t0 * b0) >> 16) + ((t1 * b1) >> 16), -32768, 32767)
    return np.clip((total + 2) >> 2, 0, 255).astype(np.uint8)


def resize(image: np.ndarray, width: int, height: int, nearest: bool) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=INTER_NEAREST if
    nearest else INTER_LINEAR)`` for an (H, W) or (H, W, C) array: nearest
    for any dtype, linear for uint8 and float32."""
    if image.shape[:2] == (height, width):
        return image.copy()
    if nearest:
        H, W = image.shape[:2]
        return image[_nearest_index(H, height)][:, _nearest_index(W, width)]
    if image.dtype == np.uint8:
        return _linear_uint8(image, width, height)
    if image.dtype == np.float32:
        return _linear_float32(image, width, height)
    raise TypeError(f"linear resize takes uint8 or float32 images, got {image.dtype}")


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
        return resize(cropped, self.new_width, self.new_height, nearest=True)

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
        cropped = resize(cropped, self.new_width, self.new_height, nearest=False)
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
