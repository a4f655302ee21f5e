"""Integrator-level any-hit alpha (hit.rahit) vs an independent NumPy oracle.

The oracle enumerates every ray/triangle intersection in t-order and
applies the reference's alpha rules (alpha = baseColourFactor.a x
baseColourTexture.a(uv); MASK cutoff; BLEND with one LCG draw per BLEND
candidate) with a scalar LCG port — validating t/tri/occlusion AND the
per-lane RNG stream advancement of the vectorised resample loop.
"""


import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_raytracer.ops.math3 import V3
from vulkan_raytracer.render.integrator import _closest, _shadow
from vulkan_raytracer.scene.scenegraph import Material, Scene

_LCG_MUL, _LCG_INC = 1664525, 1013904223


def _np_rnd(seed: int):
    seed = (_LCG_MUL * seed + _LCG_INC) & 0xFFFFFFFF
    return (seed & 0x00FFFFFF) / float(1 << 24), seed


def _quad(z):
    pos = np.array(
        [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32
    )
    nrm = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return pos, nrm, uv, idx


def _alpha_scene(with_texture=True, with_blend=True):
    """Stack: BLEND quad (z=0.5), MASK quad with checker alpha tex (z=0),
    opaque backdrop (z=-0.5)."""
    s = Scene()

    blend = Material()
    blend.base_colour_factor = np.array([1, 1, 1, 0.4], np.float32)
    blend.alpha_mode = 2 if with_blend else 0
    blend.roughness_factor = 1.0
    blend.metallic_factor = 0.0

    mask = Material()
    mask.base_colour_factor = np.array([1, 1, 1, 1.0], np.float32)
    mask.alpha_mode = 1
    mask.alpha_cutoff = 0.5
    mask.roughness_factor = 1.0
    mask.metallic_factor = 0.0
    if with_texture:
        # 4x4 checker alpha: texel alpha alternates 1.0 / 0.1
        tex = np.ones((4, 4, 4), np.float32)
        xx, yy = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        tex[..., 3] = np.where((xx + yy) % 2 == 0, 1.0, 0.1)
        mask.base_colour_tex = len(s.textures)
        s.textures.append(tex)

    back = Material()
    back.base_colour_factor = np.array([0.8, 0.8, 0.8, 1.0], np.float32)
    back.roughness_factor = 1.0
    back.metallic_factor = 0.0

    for z, m in ((0.5, blend), (0.0, mask), (-0.5, back)):
        pos, nrm, uv, idx = _quad(z)
        s.add_raw_mesh(pos, nrm, idx, m, uvs=uv)
    return s


def _sample_alpha_tex(tex, uv):
    """Nearest-4 bilinear repeat sampling matching ops/texture.py."""
    h, w = tex.shape[:2]
    x = uv[0] * w - 0.5
    y = uv[1] * h - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0
    def at(yy, xx):
        return tex[yy % h, xx % w, 3]
    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x0 + 1) * fx * (1 - fy)
        + at(y0 + 1, x0) * (1 - fx) * fy
        + at(y0 + 1, x0 + 1) * fx * fy
    )


def _oracle(tables_np, o, d, seed0, t_min, t_max):
    """Scalar t-order any-hit interpreter; returns (t, tri, seed)."""
    v0, v1, v2, uvs, mode, aval, acut, texref = tables_np
    hits = []
    for k in range(len(v0)):
        e1, e2 = v1[k] - v0[k], v2[k] - v0[k]
        p = np.cross(d, e2)
        det = e1 @ p
        if abs(det) < 1e-12:
            continue
        inv = 1.0 / det
        tv = o - v0[k]
        u = (tv @ p) * inv
        q = np.cross(tv, e1)
        v = (d @ q) * inv
        t = (e2 @ q) * inv
        if u >= 0 and v >= 0 and u + v <= 1 and t > t_min and t <= t_max:
            hits.append((t, k, u, v))
    hits.sort()
    seed = int(seed0)
    for t, k, u, v in hits:
        a = aval[k]
        if texref[k] is not None:
            w0 = 1 - u - v
            uv = w0 * uvs[k][0] + u * uvs[k][1] + v * uvs[k][2]
            a = a * _sample_alpha_tex(texref[k], uv)
        if mode[k] == 1 and a < acut[k]:
            continue
        if mode[k] == 2:
            rnd, seed = _np_rnd(seed)
            if rnd < 1.0 - a:
                continue
        return t, k, seed
    return np.inf, -1, seed


def _np_tables(scene, tables):
    v0 = np.stack([np.asarray(c) for c in (tables.v0.x, tables.v0.y, tables.v0.z)], -1)
    v1 = np.stack([np.asarray(c) for c in (tables.v1.x, tables.v1.y, tables.v1.z)], -1)
    v2 = np.stack([np.asarray(c) for c in (tables.v2.x, tables.v2.y, tables.v2.z)], -1)
    uvf = np.asarray(tables.uv)
    uvs = [
        (uvf[k, 0:2], uvf[k, 2:4], uvf[k, 4:6]) for k in range(len(v0))
    ]
    mode = np.asarray(tables.alpha.mode)
    aval = np.asarray(tables.alpha.value)
    acut = np.asarray(tables.alpha.cutoff)
    tri_mat = np.asarray(tables.tri_mat)
    tex_idx = np.asarray(tables.materials.tex_idx)
    texref = []
    for k in range(len(v0)):
        b = tex_idx[tri_mat[k], 0]
        if b >= 0:
            # the device atlas stores UNORM8 (reference image.cpp:21-58
            # parity); the scalar oracle must read the same quantisation
            q = np.round(np.clip(scene.textures[b], 0.0, 1.0) * 255.0) / np.float32(
                255.0
            )
            texref.append(q.astype(np.float32))
        else:
            texref.append(None)
    return v0, v1, v2, uvs, mode, aval, acut, texref


def _rays(n, seed=3):
    r = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = r.uniform(-0.9, 0.9, n)
    o[:, 1] = r.uniform(-0.9, 0.9, n)
    o[:, 2] = 2.0
    d = np.tile(np.array([0, 0, -1.0], np.float32), (n, 1))
    # tilt some rays so they cross texels diagonally
    d[: n // 2, 0] = r.uniform(-0.2, 0.2, n // 2)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _check_against_oracle(scene, tables, n=128):
    o, d = _rays(n)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    seeds = (np.arange(n, dtype=np.uint32) * 2654435761 + 12345).astype(np.uint32)
    (t, tri, u, v), seed_out = _closest(
        tables, ov, dv, t_min=1e-6, t_max=1e32, active=jnp.ones(n, bool),
        seed=jnp.asarray(seeds),
    )
    t, tri, seed_out = np.asarray(t), np.asarray(tri), np.asarray(seed_out)
    tn = _np_tables(scene, tables)
    for i in range(n):
        te, ke, se = _oracle(tn, o[i].astype(np.float64), d[i].astype(np.float64),
                             seeds[i], 1e-6, 1e32)
        assert tri[i] == ke, f"lane {i}: tri {tri[i]} != oracle {ke}"
        if ke >= 0:
            np.testing.assert_allclose(t[i], te, rtol=1e-4)
        assert seed_out[i] == np.uint32(se), f"lane {i}: seed stream diverged"


def test_alpha_closest_matches_oracle_dense():
    scene = _alpha_scene()
    tables = scene.upload()
    assert tables.has_alpha and tables.has_textures
    _check_against_oracle(scene, tables)


@pytest.mark.slow
def test_alpha_closest_matches_oracle_packet(bvh_kernel_path):
    """The any-hit resample loop over the BVH kernel (interpret mode)."""
    scene = _alpha_scene()
    tables = scene.upload()
    _check_against_oracle(scene, tables, n=64)


def test_alpha_shadow_matches_oracle():
    scene = _alpha_scene()
    tables = scene.upload()
    n = 96
    o, d = _rays(n, seed=9)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    seeds = (np.arange(n, dtype=np.uint32) * 747796405 + 1).astype(np.uint32)
    t_max = np.full(n, 2.6, np.float32)  # reaches past the backdrop
    occ, seed_out = _shadow(
        tables, ov, dv, t_max=jnp.asarray(t_max), active=jnp.ones(n, bool),
        seed=jnp.asarray(seeds),
    )
    occ, seed_out = np.asarray(occ), np.asarray(seed_out)
    tn = _np_tables(scene, tables)
    for i in range(n):
        te, ke, se = _oracle(tn, o[i].astype(np.float64), d[i].astype(np.float64),
                             seeds[i], 0.0, float(t_max[i]))
        assert occ[i] == (ke >= 0), f"lane {i}"
        assert seed_out[i] == np.uint32(se)


def test_mask_only_scene_is_deterministic_and_fast_path():
    """MASK-only scenes must not consume RNG, and take the same flat
    traversal as opaque scenes (alpha is decided in the resample loop)."""
    scene = _alpha_scene(with_blend=False)
    tables = scene.upload()
    assert tables.has_alpha and not tables.has_blend
    assert tables.inst is None  # the flat walk, no has_blend cliff
    n = 64
    o, d = _rays(n, seed=5)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    seeds = jnp.arange(n, dtype=jnp.uint32)
    (t1, tri1, _, _), s1 = _closest(
        tables, ov, dv, t_min=1e-6, t_max=1e32, active=jnp.ones(n, bool), seed=seeds
    )
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(seeds))
    # deterministic: repeated call identical
    (t2, tri2, _, _), _ = _closest(
        tables, ov, dv, t_min=1e-6, t_max=1e32, active=jnp.ones(n, bool), seed=seeds
    )
    np.testing.assert_array_equal(np.asarray(tri1), np.asarray(tri2))


@pytest.mark.slow
def test_alpha_end_to_end_render(monkeypatch):
    """Full render of the alpha scene: smoke + dense-vs-kernel equivalence."""
    from vulkan_raytracer.render.integrator import render_sample
    from vulkan_raytracer.scene.camera import Camera

    scene = _alpha_scene()
    tables = scene.upload()
    cam = Camera(position=np.array([0.0, 0.0, 2.5]),
                 direction=np.array([0.0, 0.0, -1.0]))
    vi = jnp.asarray(cam.view_inverse())
    pi = jnp.asarray(cam.projection_inverse())
    v_dense, _ = render_sample(tables, vi, pi, 24, 24, 2, 2)
    from vulkan_raytracer.ops import bvh_kernel
    from vulkan_raytracer.render import integrator

    monkeypatch.setattr(integrator, "DENSE_MAX_TRIS", 0)
    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: "interpret")
    v_kernel, _ = render_sample(tables, vi, pi, 24, 24, 2, 2)
    a, b = np.asarray(v_dense), np.asarray(v_kernel)
    assert np.isfinite(a).all()
    diff = np.abs(a - b).max(-1)
    assert (diff < 1e-5).mean() > 0.99
