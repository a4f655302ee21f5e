"""End-to-end integrator tests on the bundled Cornell box scene."""

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_raytracer.render import integrator as I
from vulkan_raytracer.render.renderer import Renderer, render_image
from vulkan_raytracer.scene.camera import Camera
from vulkan_raytracer.scene.scenegraph import Scene

CORNELL = "/root/reference/res/CornellBox.gltf"
W = H = 48


@pytest.fixture(scope="module")
def tables():
    s = Scene()
    s.load_model(CORNELL)
    return s.upload()


@pytest.fixture(scope="module")
def cam():
    return Camera(
        position=np.array([0.0, 1.0, 3.0]), direction=np.array([0.0, 0.0, -1.0])
    )


@pytest.mark.slow
def test_render_finite_nonnegative(tables, cam):
    img, rays = render_image(tables, cam, W, H, spp=4, max_depth=3, tonemap=False)
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert rays > 4 * W * H  # at least the primary rays
    # the light patch is the brightest region and roughly emissive-strength
    assert img.max() > 5.0
    # some illumination reaches the walls
    assert (img.sum(-1) > 1e-3).mean() > 0.3


def test_render_deterministic(tables, cam):
    a, _ = render_image(tables, cam, W, H, spp=2, max_depth=2, tonemap=False)
    b, _ = render_image(tables, cam, W, H, spp=2, max_depth=2, tonemap=False)
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_progressive_matches_batch(tables, cam):
    """Renderer.draw_frame accumulation == render_image at equal samples."""
    r = Renderer(tables, cam, W, H, max_depth=2)
    r.draw_frame()  # preview sample 0 (excluded from accumulation)
    for _ in range(3):
        r.draw_frame()
    prog = np.asarray(r.accum).reshape(H, W, 3) / 3.0
    batch, _ = render_image(tables, cam, W, H, spp=3, max_depth=2, tonemap=False)
    np.testing.assert_allclose(prog, batch, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_spp_convergence(tables, cam):
    """More samples converge toward the many-spp mean (MC consistency)."""
    ref, _ = render_image(tables, cam, W, H, spp=96, max_depth=3, tonemap=False)
    a, _ = render_image(tables, cam, W, H, spp=8, max_depth=3, tonemap=False)
    b, _ = render_image(tables, cam, W, H, spp=48, max_depth=3, start_sample=101, tonemap=False)
    err_a = np.sqrt(np.mean((a - ref) ** 2))
    err_b = np.sqrt(np.mean((b - ref) ** 2))
    assert err_b < err_a


@pytest.mark.slow
def test_preview_sample_terminates_early(tables, cam):
    """Sample 0 is the fast preview (raygen.rgen:64): depth limited, centre
    jitter; it must still produce a lit image."""
    v0, _ = I_render(tables, cam, sample=0)
    v1, _ = I_render(tables, cam, sample=1)
    assert np.isfinite(v0).all()
    assert v0.max() > 5.0  # light visible


def I_render(tables, cam, sample):
    cam.aspect = 1.0
    vi = jnp.asarray(cam.view_inverse())
    pi = jnp.asarray(cam.projection_inverse())
    val, rays = I.render_sample(tables, vi, pi, W, H, jnp.uint32(sample), 3)
    return np.asarray(val), rays


@pytest.mark.slow
def test_emissive_mis_weight_below_one(tables, cam):
    """Terminal emissive hits after bounce>0 are MIS-weighted; the light seen
    directly (bounce 0) is unweighted."""
    img, _ = render_image(tables, cam, W, H, spp=8, max_depth=3, tonemap=False)
    bright = img.reshape(-1, 3).max(axis=1)
    # direct view of the light is ~10 (emissiveStrength premultiplied)
    assert bright.max() > 9.0


@pytest.mark.slow
def test_nee_prune_bit_identical(tables, cam, monkeypatch):
    """The NdotL/black-light NEE prune (sample_lights) must not change the
    image on opaque scenes: pruned lanes' contributions are provably zero
    (radiance == 0 or BSDF == 0) whether or not the shadow ray is traced.
    Only the emissive-verify probe's ray counter may shrink (pruned lanes
    skip the pdf probe)."""
    from vulkan_raytracer.render import renderer as R

    assert not tables.has_alpha  # Cornell is opaque: the prune is active
    img_on, rays_on = R.render_image(
        tables, cam, W, H, spp=2, max_depth=3, tonemap=False
    )
    monkeypatch.setenv("VKRT_NO_NEE_PRUNE", "1")
    R._render_batch.clear_cache()
    img_off, rays_off = R.render_image(
        tables, cam, W, H, spp=2, max_depth=3, tonemap=False
    )
    R._render_batch.clear_cache()
    np.testing.assert_array_equal(img_on, img_off)
    assert rays_on <= rays_off


@pytest.mark.slow
def test_banded_render_matches_single_pass(monkeypatch):
    """Large-frame lane banding (renderer.MAX_LANES_PER_PASS) is exact."""
    import numpy as np

    from vulkan_raytracer.render import renderer as R
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera

    tables = cornell_box_scene().upload()
    cam = Camera(
        position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0])
    )
    img_1, rays_1 = R.render_image(tables, cam, 40, 24, spp=2, max_depth=2,
                                   tonemap=False)
    monkeypatch.setattr(R, "MAX_LANES_PER_PASS", 256)  # force 4 bands
    R._render_batch.clear_cache()
    img_b, rays_b = R.render_image(tables, cam, 40, 24, spp=2, max_depth=2,
                                   tonemap=False)
    R._render_batch.clear_cache()
    np.testing.assert_allclose(img_b, img_1, rtol=1e-6, atol=1e-7)
    assert rays_b == rays_1
