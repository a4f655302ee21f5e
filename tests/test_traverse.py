"""BVH build + traversal correctness vs brute-force oracles on random scenes."""

import pytest
import numpy as np
import jax.numpy as jnp

from vulkan_raytracer.accel.bvh import build_bvh
from vulkan_raytracer.ops import rng
from vulkan_raytracer.ops.intersect import brute_force_closest, ray_aabb, ray_triangle, safe_inv_dir
from vulkan_raytracer.ops.traverse import (
    AlphaTables,
    EmissivePDFTables,
    trace_closest,
    trace_emissive_pdf,
    trace_shadow,
)


def random_tris(n, seed=0, extent=4.0):
    r = np.random.default_rng(seed)
    base = r.uniform(-extent, extent, (n, 3)).astype(np.float32)
    v0 = base
    v1 = base + r.normal(0, 0.6, (n, 3)).astype(np.float32)
    v2 = base + r.normal(0, 0.6, (n, 3)).astype(np.float32)
    return v0, v1, v2


def random_rays(n, seed=1, extent=6.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_ray_triangle_basic():
    o = jnp.asarray([[0.0, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    v0 = jnp.asarray([[-1.0, -1.0, 0.0]])
    e1 = jnp.asarray([[2.0, 0.0, 0.0]])
    e2 = jnp.asarray([[0.0, 2.0, 0.0]])
    hit, t, u, v = ray_triangle(o, d, v0, e1, e2, 1e-7, 1e32)
    assert bool(hit[0]) and abs(float(t[0]) - 1.0) < 1e-6
    # barycentric weights (1-u-v, u, v): centre point at origin -> u=v=0.5
    assert abs(float(u[0]) - 0.5) < 1e-6 and abs(float(v[0]) - 0.5) < 1e-6


def test_ray_aabb_inside_origin():
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    hit = ray_aabb(o, safe_inv_dir(d), jnp.asarray([[-1.0, -1, -1]]), jnp.asarray([[1.0, 1, 1]]), 0.0, 1e32)
    assert bool(hit[0])
    # box entirely behind the ray
    hit2 = ray_aabb(o, safe_inv_dir(d), jnp.asarray([[-5.0, -1, -1]]), jnp.asarray([[-3.0, 1, 1]]), 0.0, 1e32)
    assert not bool(hit2[0])


def test_bvh_structure():
    v0, v1, v2 = random_tris(100, 0)
    bvh = build_bvh(v0, v1, v2, leaf_size=4)
    first = np.asarray(bvh.first_tri)
    miss = np.asarray(bvh.miss)
    ids = np.asarray(bvh.tri_id)
    # every original triangle appears exactly once in the padded slots
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(100))
    # skip pointers in (i, num_nodes]
    n = bvh.num_nodes
    assert (miss > np.arange(n)).all() and (miss <= n).all()
    # leaves reference valid padded blocks
    leaf_first = first[first >= 0]
    assert (leaf_first % 4 == 0).all() and (leaf_first < bvh.num_tri_slots).all()


def test_closest_matches_brute_force():
    v0, v1, v2 = random_tris(300, 2)
    bvh = build_bvh(v0, v1, v2, leaf_size=8)
    o, d = random_rays(500, 3)
    active = jnp.ones((500,), bool)
    (t, tri, u, v), _ = trace_closest(bvh, o, d, t_min=1e-7, t_max=1e32, active=active)
    tb, trib, ub, vb = brute_force_closest(
        o, d, jnp.asarray(v0), jnp.asarray(v1 - v0), jnp.asarray(v2 - v0), 1e-7, 1e32
    )
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(trib))
    np.testing.assert_allclose(np.asarray(t), np.asarray(tb), rtol=1e-5)
    hitm = np.asarray(tri) >= 0
    np.testing.assert_allclose(np.asarray(u)[hitm], np.asarray(ub)[hitm], atol=1e-5)
    np.testing.assert_allclose(np.asarray(v)[hitm], np.asarray(vb)[hitm], atol=1e-5)


@pytest.mark.slow
def test_closest_respects_active_and_tmax():
    v0, v1, v2 = random_tris(50, 4)
    bvh = build_bvh(v0, v1, v2, leaf_size=8)
    o, d = random_rays(100, 5)
    active = jnp.asarray(np.arange(100) % 2 == 0)
    (t, tri, _, _), _ = trace_closest(bvh, o, d, t_min=1e-7, t_max=1e32, active=active)
    assert (np.asarray(tri)[~np.asarray(active)] == -1).all()
    # a tiny t_max forbids all hits
    (t2, tri2, _, _), _ = trace_closest(bvh, o, d, t_min=1e-7, t_max=1e-4, active=jnp.ones((100,), bool))
    assert (np.asarray(tri2) == -1).all()


def test_shadow_matches_brute_force():
    v0, v1, v2 = random_tris(200, 6)
    bvh = build_bvh(v0, v1, v2, leaf_size=8)
    o, d = random_rays(400, 7)
    tmax = jnp.asarray(np.random.default_rng(8).uniform(0.5, 10.0, 400).astype(np.float32))
    occ, _ = trace_shadow(bvh, o, d, t_max=tmax, active=jnp.ones((400,), bool))
    tb, trib, _, _ = brute_force_closest(
        o, d, jnp.asarray(v0), jnp.asarray(v1 - v0), jnp.asarray(v2 - v0), 0.0, 1e32
    )
    want = (np.asarray(trib) >= 0) & (np.asarray(tb) <= np.asarray(tmax))
    np.testing.assert_array_equal(np.asarray(occ), want)


def test_alpha_mask_ignores_below_cutoff():
    # one triangle, MASK mode with alpha below cutoff -> never hit
    v0 = np.array([[-1, -1, 0]], np.float32)
    v1 = np.array([[3, -1, 0]], np.float32)
    v2 = np.array([[-1, 3, 0]], np.float32)
    bvh = build_bvh(v0, v1, v2, leaf_size=4)
    alpha = AlphaTables(
        mode=jnp.asarray([1], jnp.int32),
        value=jnp.asarray([0.2], jnp.float32),
        cutoff=jnp.asarray([0.5], jnp.float32),
    )
    o = jnp.asarray([[0.0, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    seed = jnp.zeros((1,), jnp.uint32)
    (t, tri, _, _), _ = trace_closest(
        bvh, o, d, t_min=1e-7, t_max=1e32, active=jnp.ones((1,), bool), seed=seed, alpha=alpha
    )
    assert int(tri[0]) == -1
    occ, _ = trace_shadow(
        bvh, o, d, t_max=10.0, active=jnp.ones((1,), bool), seed=seed, alpha=alpha
    )
    assert not bool(occ[0])


def test_alpha_blend_stochastic_rate():
    # BLEND with alpha=0.3 -> hit probability ~0.3 over many seeds
    v0 = np.array([[-5, -5, 0]], np.float32)
    v1 = np.array([[10, -5, 0]], np.float32)
    v2 = np.array([[-5, 10, 0]], np.float32)
    bvh = build_bvh(v0, v1, v2, leaf_size=4)
    alpha = AlphaTables(
        mode=jnp.asarray([2], jnp.int32),
        value=jnp.asarray([0.3], jnp.float32),
        cutoff=jnp.asarray([0.5], jnp.float32),
    )
    n = 4096
    o = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    seed = rng.tea(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    (t, tri, _, _), seed2 = trace_closest(
        bvh, o, d, t_min=1e-7, t_max=1e32, active=jnp.ones((n,), bool), seed=seed, alpha=alpha
    )
    rate = float(np.mean(np.asarray(tri) >= 0))
    assert abs(rate - 0.3) < 0.03
    # seeds advanced exactly one draw on every lane (every lane intersects)
    _, want = rng.rnd(seed)
    np.testing.assert_array_equal(np.asarray(seed2), np.asarray(want))


def test_emissive_pdf_matches_brute_force():
    v0, v1, v2 = random_tris(40, 9, extent=2.0)
    ebvh = build_bvh(v0, v1, v2, leaf_size=4)
    te = 40
    r = np.random.default_rng(10)
    p_delta = r.uniform(0.01, 1.0, te).astype(np.float32)
    p_delta /= p_delta.sum()
    n0 = r.normal(size=(te, 3)).astype(np.float32)
    n1 = r.normal(size=(te, 3)).astype(np.float32)
    n2 = r.normal(size=(te, 3)).astype(np.float32)
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1).astype(np.float32)
    tables = EmissivePDFTables(
        p_delta=jnp.asarray(p_delta),
        area=jnp.asarray(area),
        n0=jnp.asarray(n0),
        n1=jnp.asarray(n1),
        n2=jnp.asarray(n2),
    )
    o, d = random_rays(200, 11, extent=3.0)
    pdf = trace_emissive_pdf(ebvh, tables, o, d, t_min=1e-7, active=jnp.ones((200,), bool))

    # brute force oracle
    hit, t, u, v = ray_triangle(
        np.asarray(o)[:, None, :],
        np.asarray(d)[:, None, :],
        jnp.asarray(v0)[None],
        jnp.asarray(v1 - v0)[None],
        jnp.asarray(v2 - v0)[None],
        1e-7,
        1e32,
    )
    hit, t, u, v = map(np.asarray, (hit, t, u, v))
    w0 = (1 - u - v)[..., None]
    nrm = w0 * n0[None] + u[..., None] * n1[None] + v[..., None] * n2[None]
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    cos = np.abs(np.sum(nrm * np.asarray(d)[:, None, :], axis=-1))
    contrib = p_delta[None] * t * t / np.maximum(area[None] * cos, 1e-30)
    want = np.sum(np.where(hit, contrib, 0.0), axis=1)
    np.testing.assert_allclose(np.asarray(pdf), want, rtol=2e-4, atol=1e-6)
