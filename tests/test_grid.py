"""Uniform-grid DDA traversal correctness vs brute force."""

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_raytracer.accel.grid import build_grid
from vulkan_raytracer.ops.grid_traverse import grid_closest, grid_shadow
from vulkan_raytracer.ops.intersect import brute_force_closest
from vulkan_raytracer.ops.math3 import V3
from vulkan_raytracer.scene.builtin import triangle_soup_scene


@pytest.fixture(scope="module")
def soup():
    """Upload tables plus a grid built over them (the grid is not part of
    the render tables: it is a traversal alternative, built on request)."""
    s = triangle_soup_scene(1500, seed=11)
    t = s.upload()
    v = lambda c: np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)
    v0, v1, v2 = v(t.v0), v(t.v1), v(t.v2)
    t = _WithGrid(t, build_grid(v0, v1, v2))
    return t, v0, v1, v2


class _WithGrid:
    """Scene tables with a ``grid`` attribute, as the grid walk expects."""

    def __init__(self, tables, grid):
        self._tables = tables
        self.grid = grid

    def __getattr__(self, name):
        return getattr(self._tables, name)


def _rays(n, seed, extent=14.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ov = V3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dv = V3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2]))
    return o, d, ov, dv


def test_grid_build_covers_all_triangles(soup):
    t, v0, v1, v2 = soup
    g = t.grid
    ids = np.asarray(g.tri_ids)
    assert set(ids.tolist()) == set(range(v0.shape[0]))
    start = np.asarray(g.cell_start)
    assert start[0] == 0 and start[-1] == ids.shape[0]
    assert (np.diff(start) >= 0).all()


def test_grid_closest_matches_brute_force(soup):
    t, v0, v1, v2 = soup
    o, d, ov, dv = _rays(400, 5)
    act = jnp.ones((400,), bool)
    (tg, trig, ug, vg), _ = grid_closest(
        t, t.grid, ov, dv, t_min=1e-7, t_max=1e32, active=act
    )
    tb, trib, ub, vb = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(v1 - v0),
        jnp.asarray(v2 - v0), 1e-7, 1e32,
    )
    np.testing.assert_array_equal(np.asarray(trig), np.asarray(trib))
    m = np.asarray(trig) >= 0
    np.testing.assert_allclose(np.asarray(tg)[m], np.asarray(tb)[m], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ug)[m], np.asarray(ub)[m], atol=1e-4)


@pytest.mark.slow
def test_grid_closest_respects_tmax_and_active(soup):
    t, *_ = soup
    o, d, ov, dv = _rays(100, 6)
    act = jnp.asarray(np.arange(100) % 2 == 0)
    (tg, trig, _, _), _ = grid_closest(
        t, t.grid, ov, dv, t_min=1e-7, t_max=1e32, active=act
    )
    assert (np.asarray(trig)[~np.asarray(act)] == -1).all()
    (t2, tri2, _, _), _ = grid_closest(
        t, t.grid, ov, dv, t_min=1e-7, t_max=1e-3, active=jnp.ones((100,), bool)
    )
    assert (np.asarray(tri2) == -1).all()


@pytest.mark.slow
def test_grid_shadow_matches_brute_force(soup):
    t, v0, v1, v2 = soup
    o, d, ov, dv = _rays(300, 7)
    tmax = np.random.default_rng(8).uniform(1.0, 25.0, 300).astype(np.float32)
    occ, _ = grid_shadow(
        t, t.grid, ov, dv, t_max=jnp.asarray(tmax), active=jnp.ones((300,), bool)
    )
    tb, trib, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(v1 - v0),
        jnp.asarray(v2 - v0), 0.0, 1e32,
    )
    want = (np.asarray(trib) >= 0) & (np.asarray(tb) <= tmax)
    np.testing.assert_array_equal(np.asarray(occ), want)


@pytest.mark.slow
def test_grid_rays_from_inside(soup):
    """Rays originating inside the grid volume (every bounce ray)."""
    t, v0, v1, v2 = soup
    r = np.random.default_rng(9)
    o = r.uniform(-5, 5, (200, 3)).astype(np.float32)
    d = r.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ov = V3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dv = V3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2]))
    (tg, trig, _, _), _ = grid_closest(
        t, t.grid, ov, dv, t_min=1e-7, t_max=1e32, active=jnp.ones((200,), bool)
    )
    tb, trib, _, _ = brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(v1 - v0),
        jnp.asarray(v2 - v0), 1e-7, 1e32,
    )
    np.testing.assert_array_equal(np.asarray(trig), np.asarray(trib))
