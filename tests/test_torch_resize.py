"""The port's OpenCV-free resize (data/preprocess.py::resize) against
cv2.resize, and PreprocessImage against the JAX package's on the same
frames.

Target: equality. Linear on uint8 follows OpenCV's fixed-point path, linear
on float32 its IPP path (one fma per axis), nearest its index formula. The
one known departure has a test of its own: a float32 source under about 25
pixels wide with 3 channels, enlarged about tenfold, differs by one float32
step of its value range at a few border columns (ROADMAP Queue 3).
"""

import cv2
import numpy as np
import pytest

from dvmvs_tpu.data.preprocess import PreprocessImage as JPreprocessImage
from dvmvs_tpu_torch.data.preprocess import PreprocessImage, resize

# (source H, W), (target H, W)
CASES = {
    "scannet_crop_600x480_to_320x256": ((480, 600), (256, 320)),
    "identity_96x64": ((64, 96), (64, 96)),
    "upscale_96x64_to_160x128": ((64, 96), (128, 160)),
    "odd_101x77_to_64x48": ((77, 101), (48, 64)),
    "halve_640x512_to_320x256": ((512, 640), (256, 320)),
    "shrink_320x256_to_300x240": ((256, 320), (240, 300)),
    "upscale_odd_40x30_to_51x77": ((30, 40), (77, 51)),
}


def _frames(seed, shape):
    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, shape + (3,)).astype(np.uint8)
    # a smooth field as well: real frames are not white noise
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    smooth = (127.5 + 120 * np.sin(xx / 7.0 + yy / 11.0))[..., None] * np.ones(3)
    return rgb, np.clip(smooth, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("case", list(CASES))
def test_linear_resize_equals_cv2(case):
    (H, W), (h, w) = CASES[case]
    for i, rgb in enumerate(_frames(list(CASES).index(case), (H, W))):
        for image in (rgb, rgb.astype(np.float32),
                      rgb.astype(np.float32) + np.float32(0.37) * i,
                      np.ascontiguousarray(rgb[:, :, 0])):
            want = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
            got = resize(image, w, h, nearest=False)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_nearest_resize_equals_cv2(case):
    (H, W), (h, w) = CASES[case]
    rs = np.random.RandomState(3)
    depth = rs.uniform(0.2, 6.0, (H, W)).astype(np.float32)
    depth_mm = rs.randint(0, 60000, (H, W)).astype(np.uint16)
    rgb = rs.randint(0, 256, (H, W, 3)).astype(np.float32)
    for image in (depth, depth_mm, rgb):
        want = cv2.resize(image, (w, h), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize(image, w, h, nearest=True), want)


def test_linear_resize_float32_tenfold_departure():
    """16x10 -> 160x100, 3 channels of integer values in [0, 256) as
    float32: 95 of the 48000 values (95 of 16000 pixels) differ from
    cv2.resize, each by 2**-16, one float32 step for values in [128, 256)."""
    image = np.random.RandomState(0).randint(0, 256, (10, 16, 3)).astype(np.float32)
    want = cv2.resize(image, (160, 100), interpolation=cv2.INTER_LINEAR)
    got = resize(image, 160, 100, nearest=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -16)
    assert 0 < int((got != want).any(axis=-1).sum()) <= 95
    assert int((got != want).sum()) <= 95


def test_linear_resize_rejects_other_dtypes():
    with pytest.raises(TypeError):
        resize(np.zeros((8, 8), np.float64), 4, 4, nearest=False)


@pytest.mark.parametrize("source,crop", [((480, 640), 0), ((480, 640), 20), ((968, 1296), 0),
                                         ((64, 96), 0)])
def test_preprocess_equals_the_jax_package(source, crop):
    """ScanNet (640x480), a distortion margin, 7-Scenes-like 1296x968 and the
    identity: the centre crop, the resize to 320x256 (96x64 for the last),
    the normalisation and the updated intrinsics."""
    H, W = source
    h, w = (64, 96) if source == (64, 96) else (256, 320)
    K = np.array([[0.9 * W, 0, W / 2 - 3.5], [0, 0.9 * W, H / 2 + 2.25], [0, 0, 1]])
    port = PreprocessImage(K, W, H, w, h, distortion_crop=crop)
    ref = JPreprocessImage(K, W, H, w, h, distortion_crop=crop)
    rgb, smooth = _frames(7, (H, W))
    depth = np.random.RandomState(8).uniform(0.3, 8.0, (H, W)).astype(np.float32)
    for image in (rgb.astype(np.float32), smooth.astype(np.float32)):
        for args in ((255.0, [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
                     (1.0, [0.0] * 3, [1.0] * 3, False)):
            got, want = port.apply_rgb(image, *args), ref.apply_rgb(image, *args)
            assert got.dtype == want.dtype and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.apply_depth(depth), ref.apply_depth(depth))
    np.testing.assert_array_equal(port.get_updated_intrinsics(), ref.get_updated_intrinsics())
