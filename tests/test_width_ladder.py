"""Wavefront width ladder: bit-exactness vs the single full-width loop.

Under the opt-in coherence repacking (``VKRT_FORCE_REPACK=1``) the bounce
loop (render/integrator.render_sample) halves then quarters the wavefront
width once the live count fits the prefix (dead
lanes sort last, so the live wavefront is a prefix after the coherence
sort).  Dead lanes' state is invariant under bounce(), so the ladder must
be BIT-identical to the full-width loop — this pins it on a scene whose
occupancy collapses fast (most primary rays miss to the skybox), which
drives both the half and quarter tiers.
"""

import numpy as np

import jax.numpy as jnp

from vulkan_raytracer.render.integrator import render_sample
from vulkan_raytracer.scene.camera import Camera
from vulkan_raytracer.scene.procedural import sky_hdr
from vulkan_raytracer.scene.builtin import cornell_box_scene


def _open_scene():
    """Cornell geometry viewed from afar: most primaries miss to the sky,
    so live occupancy collapses below 1/2 then 1/4 within two bounces."""
    s = cornell_box_scene()
    s.skybox = sky_hdr(h=16, w=32)
    s.skybox_strength = 1.0
    return s.upload()


def test_width_ladder_bit_identical(monkeypatch):
    t = _open_scene()
    cam = Camera(position=np.array([0.0, 1.0, 14.0]),
                 direction=np.array([0.0, 0.0, -1.0]))
    cam.aspect = 1.0
    vi = jnp.asarray(cam.view_inverse())
    pi = jnp.asarray(cam.projection_inverse())

    monkeypatch.setenv("VKRT_FORCE_REPACK", "1")

    monkeypatch.setenv("VKRT_NO_WIDTH_LADDER", "1")
    ref, rays_ref = render_sample(t, vi, pi, 32, 32, 2, 4)
    monkeypatch.delenv("VKRT_NO_WIDTH_LADDER")
    got, rays_got = render_sample(t, vi, pi, 32, 32, 2, 4)

    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
    assert int(rays_ref) == int(rays_got)
    # the scene must actually exercise the ladder: plenty of sky misses
    assert np.asarray(ref).reshape(-1, 3).max(axis=1).min() >= 0.0
