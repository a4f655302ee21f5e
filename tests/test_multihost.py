"""Multi-host layer (parallel/multihost.py) on the single-process mesh.

These tests pin the single-process contracts the multi-host path is
built from (tests/test_multihost_2proc.py forms a REAL two-process
fleet over localhost on top of them) — broadcast
is the identity on one process, the fleet mesh covers every device, and
the multihost render is exactly the sharded render (gather hook
included) — plus drive the ``gather`` override through the banded path
to prove the hook carries the same bytes ``jax.device_get`` would.
"""

import jax
import numpy as np
import pytest

from vulkan_raytracer.parallel.multihost import (
    broadcast_scene_tables,
    is_io_host,
    make_fleet_mesh,
    render_image_multihost,
)
from vulkan_raytracer.parallel.sharding import render_image_sharded
from vulkan_raytracer.render.renderer import render_image
from vulkan_raytracer.scene.builtin import cornell_box_scene
from vulkan_raytracer.scene.camera import Camera


def _cam():
    return Camera(
        position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0])
    )


def test_broadcast_is_identity_single_process():
    tables = cornell_box_scene().upload()
    out = broadcast_scene_tables(tables)
    la, lb = jax.tree.leaves(tables), jax.tree.leaves(out)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert is_io_host()


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_fleet_mesh_covers_all_devices():
    mesh = make_fleet_mesh()
    assert mesh.devices.size == len(jax.devices())


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
@pytest.mark.slow
def test_multihost_render_matches_single_device():
    tables = cornell_box_scene().upload()
    img_m, rays_m = render_image_multihost(
        tables, _cam(), 32, 8, spp=2, max_depth=2, tonemap=False
    )
    img_1, rays_1 = render_image(
        tables, _cam(), 32, 8, spp=2, max_depth=2, tonemap=False
    )
    np.testing.assert_allclose(img_m, img_1, rtol=1e-5, atol=1e-6)
    assert rays_m == rays_1


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_gather_hook_carries_identical_bytes():
    """The DCN-allgather seam: force a non-default gather through the
    sharded renderer and require the image it assembles to be exactly
    the default-gather image (the multi-host path differs ONLY here)."""
    from jax.experimental import multihost_utils

    tables = cornell_box_scene().upload()
    mesh = make_fleet_mesh()
    kw = dict(spp=2, max_depth=2, mesh=mesh, tonemap=False)
    img_d, rays_d = render_image_sharded(tables, _cam(), 32, 8, **kw)
    img_g, rays_g = render_image_sharded(
        tables, _cam(), 32, 8,
        gather=lambda x: multihost_utils.process_allgather(x, tiled=True), **kw
    )
    np.testing.assert_array_equal(img_d, img_g)
    assert rays_d == rays_g
