"""The port's OpenCV-free image functions (binocular3dgs_torch/init/image_io.py)
against cv2: reading, uint8 INTER_LINEAR resize and RGB -> grey bit for bit;
the float32 resize of the Farneback pyramid within 4 units in the last
place of its range (float32 sums in another order)."""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from binocular3dgs_torch.init.image_io import (
    imread_rgb, resize_linear_f32, resize_linear_u8, rgb_to_gray_u8,
)

# (src W, H) -> (dst w, h): the pipeline's exact 2x (4032x3024 -> 2016x1512
# is the same case at full size) and 4x downscales, the matcher's quarter of
# odd sizes, upscales and ratios that round the weights every way
SIZES = [
    ((64, 48), (32, 24)), ((2016, 1512), (504, 378)), ((101, 77), (40, 31)),
    ((640, 480), (37, 29)), ((500, 400), (123, 321)), ((33, 45), (50, 60)),
    ((20, 20), (60, 60)), ((7, 9), (100, 90)), ((3, 3), (1000, 2)), ((1000, 1000), (999, 998)),
]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_u8_bit_exact(src, dst, channels):
    rng = np.random.default_rng(src[0] * 7 + dst[0])
    shape = (src[1], src[0]) + ((channels,) if channels == 3 else ())
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    got = resize_linear_u8(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst))


@pytest.mark.parametrize("src,dst", SIZES[:6], ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_f32_within_ulps(src, dst):
    rng = np.random.default_rng(1)
    img = (rng.random((src[1], src[0])) * 255).astype(np.float32)
    got = resize_linear_f32(torch.from_numpy(img)[None], dst)[0].numpy()
    assert np.abs(got - cv2.resize(img, dst)).max() <= 4 * np.spacing(np.float32(255))


def test_rgb_to_gray_bit_exact():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (257, 301, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb_to_gray_u8(torch.from_numpy(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("ext,mode", [("png", "RGB"), ("png", "RGBA"), ("png", "L"),
                                      ("jpg", "RGB")])
def test_imread_matches_cv2(tmp_path, ext, mode):
    """PNG in three modes and a JPEG (LLFF's format): the same pixels as
    cv2.imread + BGR2RGB (the JPEG through the same libjpeg decoder
    settings)."""
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (48, 64, len(mode)), dtype=np.uint8)
    path = str(tmp_path / f"im.{ext}")
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    got = imread_rgb(path)
    assert got.dtype == np.uint8 and got.flags.writeable
    np.testing.assert_array_equal(got, want)
