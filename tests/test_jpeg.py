"""Baseline JPEG decoder vs Pillow/libjpeg ground truth.

The reference decodes JPEG glTF textures through stb_image (image.cpp:21);
our decoder must agree with an independent libjpeg implementation within
IDCT/upsampling tolerance across subsampling modes and restart intervals.
"""

import io

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")

from vulkan_raytracer.utils.image import decode_texture
from vulkan_raytracer.utils.jpeg import JPEGError, decode_jpeg


def _test_image():
    rng = np.random.default_rng(0)
    base = np.zeros((50, 70, 3), np.uint8)
    base[..., 0] = np.linspace(0, 255, 70, dtype=np.uint8)[None, :]
    base[..., 1] = np.linspace(0, 255, 50, dtype=np.uint8)[:, None]
    base[10:30, 20:50, 2] = 200
    return base + rng.integers(0, 30, base.shape, dtype=np.uint8)


@pytest.mark.parametrize(
    "subsampling,quality,mean_tol",
    [(0, 95, 1.0), (2, 85, 1.5), (1, 75, 1.5)],
    ids=["444_q95", "420_q85", "422_q75"],
)
def test_jpeg_matches_libjpeg(subsampling, quality, mean_tol):
    base = _test_image()
    buf = io.BytesIO()
    PIL_Image.fromarray(base).save(
        buf, "JPEG", quality=quality, subsampling=subsampling
    )
    data = buf.getvalue()
    mine = decode_jpeg(data).astype(np.int32)
    ref = np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGB")).astype(np.int32)
    assert mine.shape == ref.shape
    assert np.abs(mine - ref).mean() < mean_tol


def test_jpeg_greyscale():
    base = _test_image()[..., 0]
    buf = io.BytesIO()
    PIL_Image.fromarray(base, "L").save(buf, "JPEG", quality=90)
    mine = decode_jpeg(buf.getvalue())
    ref = np.asarray(PIL_Image.open(buf))
    assert np.abs(mine[..., 0].astype(np.int32) - ref.astype(np.int32)).max() <= 2


def test_jpeg_restart_intervals():
    cv2 = pytest.importorskip("cv2")
    base = _test_image()
    ok, enc = cv2.imencode(
        ".jpg",
        base[..., ::-1],
        [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    )
    assert ok
    data = bytes(enc)
    assert b"\xff\xdd" in data  # DRI present
    mine = decode_jpeg(data).astype(np.int32)
    ref = np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGB")).astype(np.int32)
    assert np.abs(mine - ref).mean() < 1.5


def test_progressive_rejected_loudly():
    buf = io.BytesIO()
    PIL_Image.fromarray(_test_image()).save(buf, "JPEG", progressive=True)
    with pytest.raises(JPEGError, match="baseline"):
        decode_jpeg(buf.getvalue())


def test_decode_texture_jpeg_unorm():
    """decode_texture promotes JPEG to (H, W, 4) UNORM floats like PNG."""
    base = _test_image()
    buf = io.BytesIO()
    PIL_Image.fromarray(base).save(buf, "JPEG", quality=95, subsampling=0)
    tex = decode_texture(buf.getvalue())
    assert tex.shape == (50, 70, 4)
    assert tex.dtype == np.float32
    np.testing.assert_allclose(tex[..., 3], 1.0)
    assert np.abs(tex[..., :3] * 255.0 - base).mean() < 4.5  # q95 quantisation
