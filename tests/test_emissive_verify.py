"""Emissive-verify epsilon semantics on near-coplanar emissive surfaces.

The reference verifies an NEE sample by tracing a closest-hit ray and
accepting it only if the hit IS the sampled triangle (emissive.rchit:47,
tMax = dist + EPS at lightsample.glsl:131).  The integrator replaces this
with a terminate-on-first-hit occlusion trace to
``t_max = dist*(1 - 1e-4) - 1e-5`` (render/integrator.py:_sample_emissive),
which answers the same question — "is anything strictly closer than the
sampled point?" — except when another surface lies *within the epsilon
band* of the sampled point.  This file pins that deviation band with two
stacked emissive panels at separations straddling ``1e-4 * dist``:

* separation well above the band: decision-for-decision agreement with the
  reference's identity-check semantics (brute-force closest hit in NumPy);
* separation inside the band: the identity check rejects every sample on
  the occluded rear panel while the occlusion form accepts them — the
  documented deviation, confined to coincident-emitter geometry where the
  occlusion form is the energy-conserving answer (the rear panel's
  radiance equals the front panel's, and the MIS pdf probe already sums
  both panels either way, emissivepdf.rahit:57-67).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_raytracer.ops.math3 import V3
from vulkan_raytracer.render import integrator as I
from vulkan_raytracer.render import oracle
from vulkan_raytracer.render.renderer import render_image
from vulkan_raytracer.scene.camera import Camera
from vulkan_raytracer.scene.scenegraph import Material, Scene

PANEL_Y = 2.0  # rear (sampled) panel height; shading points sit near y=0
HALF = 0.5  # panel half-extent in x/z


def _quad_mesh(y, half, down=True):
    """A horizontal quad at height ``y``; normal -y if ``down``."""
    pos = np.array(
        [
            [-half, y, -half],
            [half, y, -half],
            [half, y, half],
            [-half, y, half],
        ],
        np.float32,
    )
    n = np.array([0.0, -1.0 if down else 1.0, 0.0], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    if not down:
        idx = idx[::-1].copy()
    return pos, np.tile(n, (4, 1)), idx


def _two_panel_scene(delta: float) -> Scene:
    """Diffuse floor + two equal emissive panels ``delta`` apart.

    Panel A (rear, at PANEL_Y) is the one the test samples; panel B sits
    ``delta`` closer to the floor and occludes it.
    """
    s = Scene()
    white = Material()
    white.metallic_factor = 0.0
    white.roughness_factor = 1.0
    em = Material()
    em.emissive_factor = np.array([5.0, 5.0, 5.0], np.float32)
    em.metallic_factor = 0.0

    fp, fn, fi = _quad_mesh(0.0, 2.0, down=False)  # floor, normal +y
    s.add_raw_mesh(fp, fn, fi, white)
    ap, an, ai = _quad_mesh(PANEL_Y, HALF, down=True)  # panel A (rear)
    s.add_raw_mesh(ap, an, ai, em)
    bp, bn, bi = _quad_mesh(PANEL_Y - delta, HALF, down=True)  # panel B
    s.add_raw_mesh(bp, bn, bi, em)
    return s


def _closest_bruteforce(tables, o, d, t_max):
    """NumPy Moller-Trumbore closest hit over every scene triangle.

    Returns (t, tri) with tri=-1 on miss — the reference's verify trace
    (closest-hit, then identity check by the caller)."""
    v0 = np.stack([np.asarray(c) for c in (tables.v0.x, tables.v0.y, tables.v0.z)], -1)
    v1 = np.stack([np.asarray(c) for c in (tables.v1.x, tables.v1.y, tables.v1.z)], -1)
    v2 = np.stack([np.asarray(c) for c in (tables.v2.x, tables.v2.y, tables.v2.z)], -1)
    e1 = (v1 - v0)[None]  # (1, T, 3)
    e2 = (v2 - v0)[None]
    do = d[:, None]  # (N, 1, 3)
    p = np.cross(do, e2)
    det = np.sum(e1 * p, -1)  # (N, T)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tv = o[:, None] - v0[None]
    u = np.sum(tv * p, -1) * inv
    q = np.cross(tv, e1)
    v = np.sum(do * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    hit = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
    hit &= (t > 1e-7) & (t < t_max[:, None])
    t = np.where(hit, t, np.inf)
    ti = np.argmin(t, -1)
    tb = t[np.arange(t.shape[0]), ti]
    return tb, np.where(np.isfinite(tb), ti, -1)


def _verify_decisions(tables, delta, n=64, seed=0):
    """(ours_accept, identity_accept, on_rear) for NEE samples on panel A."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    h[:, 1] = 0.0
    o = h + np.array([0.0, 1e-3, 0.0], np.float32)  # BIAS along floor normal
    p = rng.uniform(-HALF, HALF, (n, 3)).astype(np.float32)
    p[:, 1] = PANEL_Y  # sampled points on panel A (rear)
    ray = p - o
    dist = np.linalg.norm(ray, axis=-1).astype(np.float32)
    d = (ray / dist[:, None]).astype(np.float32)

    # the integrator's occlusion form (production _shadow dispatch)
    t_occ = dist * np.float32(1.0 - 1e-4) - np.float32(1e-5)
    occ, _ = I._shadow(
        tables,
        V3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2])),
        V3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])),
        t_max=jnp.asarray(t_occ),
        active=jnp.ones(n, bool),
        seed=jnp.zeros(n, jnp.uint32),
    )
    ours_accept = ~np.asarray(occ)

    # the reference's identity check: closest hit within dist+EPS must BE
    # the sampled triangle; "is the sampled one" detected geometrically via
    # the hit height (panel A at PANEL_Y, panel B at PANEL_Y - delta)
    t_hit, tri = _closest_bruteforce(tables, o, d, dist + np.float32(1e-4))
    hit_y = o[:, 1] + t_hit * d[:, 1]
    identity_accept = (tri >= 0) & (hit_y > PANEL_Y - 0.5 * delta)
    return ours_accept, identity_accept


def test_verify_agrees_outside_epsilon_band():
    """Separation 5e-3 >> 1e-4*dist: occlusion == identity, every sample."""
    tables = _two_panel_scene(5e-3).upload()
    ours, ident = _verify_decisions(tables, 5e-3)
    np.testing.assert_array_equal(ours, ident)
    # panel B fully shadows A from below, so every A-sample is rejected
    assert not ident.any()


def test_verify_deviation_confined_to_band():
    """Separation 1e-4 < 1e-4*dist(~2): the pinned deviation.

    The identity check rejects every rear-panel sample (panel B is hit
    first); the occlusion form accepts them all (B is inside the epsilon).
    Both panels emit identically and the pdf probe sums both either way,
    so each accepted rear sample carries the same estimator value as the
    front-panel sample the reference would need instead.
    """
    tables = _two_panel_scene(1e-4).upload()
    ours, ident = _verify_decisions(tables, 1e-4)
    assert not ident.any()  # reference semantics: all rejected
    assert ours.all()  # occlusion semantics: all accepted (the deviation)


@pytest.mark.slow
def test_two_panel_renders_match_oracle():
    """End-to-end consistency at a separation straddling the band."""
    cam = Camera(
        position=np.array([0.0, 1.0, 0.0]), direction=np.array([0.0, -1.0, 0.2])
    )
    for delta in (5e-3, 1e-4):
        tables = _two_panel_scene(delta).upload()
        img_j, _ = render_image(tables, cam, 24, 24, spp=2, max_depth=2, tonemap=False)
        img_o = oracle.render_image(tables, cam, 24, 24, spp=2, max_depth=2)
        rmse = float(np.sqrt(np.mean((img_j - img_o) ** 2)))
        assert rmse < 2e-3, f"delta={delta}: RMSE {rmse} vs oracle"
        assert img_j.mean() > 1e-3  # panels actually light the floor
