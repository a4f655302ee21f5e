"""Sample-batched and banded wave renders must equal per-sample sums.

The renderer batches several samples' lanes into one dispatch (lane =
(pixel, sample)) and splits large frames into lane bands; both paths must
reproduce the sequential per-sample accumulation exactly (same per-lane
RNG streams; only fp summation order may differ, and for the small scenes
here it does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_raytracer.render import renderer as rnd
from vulkan_raytracer.render.integrator import render_sample
from vulkan_raytracer.render.renderer import (
    camera_uniforms,
    render_image,
)
from vulkan_raytracer.scene.builtin import cornell_box_scene
from vulkan_raytracer.scene.camera import Camera


@pytest.fixture(scope="module")
def setup():
    t = cornell_box_scene().upload()
    cam = Camera(
        position=np.array([0.0, 1.0, 3.0]), direction=np.array([0.0, 0.0, -1.0])
    )
    cam.aspect = 1.0
    vi, pi = camera_uniforms(cam)
    return t, cam, vi, pi


def _per_sample_sum(t, vi, pi, w, h, spp, depth):
    acc = np.zeros((w * h, 3), np.float32)
    for s in range(1, spp + 1):
        r, _ = render_sample(t, vi, pi, w, h, np.uint32(s), depth)
        acc += np.asarray(r)
    return acc


@pytest.mark.slow
def test_batched_waves_match_per_sample(setup):
    t, cam, vi, pi = setup
    w = h = 24
    img, _ = render_image(t, cam, w, h, spp=4, max_depth=3, tonemap=False)
    ref = _per_sample_sum(t, vi, pi, w, h, 4, 3).reshape(h, w, 3) / 4.0
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-5)


@pytest.mark.slow
def test_banded_waves_match_per_sample(setup, monkeypatch):
    """Force the banded path with a tiny lane budget: 24x24 x 4spp at a
    640-lane cap exercises band splitting, in-band sample batching, the
    padding lane, and the inverse permutation."""
    t, cam, vi, pi = setup
    w = h = 24
    monkeypatch.setattr(rnd, "MAX_LANES_PER_PASS", 640)
    img, _ = render_image(t, cam, w, h, spp=4, max_depth=3, tonemap=False)
    ref = _per_sample_sum(t, vi, pi, w, h, 4, 3).reshape(h, w, 3) / 4.0
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-5)


def test_banded_tiny_matches_batch(setup, monkeypatch):
    """Fast default-tier sibling of the banded equivalence render: force
    banding at a tiny frame by shrinking MAX_LANES_PER_PASS so the
    band x sample-chunk loop runs in seconds (the full-size variants
    above are the slow tier)."""
    t, cam, vi, pi = setup
    w = h = 16
    img_ref, rays_ref = render_image(t, cam, w, h, spp=2, max_depth=2,
                                     tonemap=False)
    monkeypatch.setattr(rnd, "MAX_LANES_PER_PASS", 256)
    img_band, rays_band = render_image(t, cam, w, h, spp=2, max_depth=2,
                                       tonemap=False)
    assert rays_band == rays_ref
    np.testing.assert_array_equal(np.asarray(img_band), np.asarray(img_ref))
