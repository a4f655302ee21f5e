"""TLAS instancing: O(tris + instances) upload + two-level traversal.

The reference shares one BLAS across many TLAS instances
(accelerationstructure.cpp:157-177); these tests pin the instanced path
(ops/instanced.py, scenegraph._upload_instanced) against the flattened
renderer on the same scenes — the flattened path is itself oracle-validated
(tests/test_rmse.py), so agreement transfers the quality bound.
"""

import numpy as np
import pytest

from vulkan_raytracer.render.renderer import render_image
from vulkan_raytracer.scene.camera import Camera
from vulkan_raytracer.scene.scenegraph import Material, Primitive, Scene

RMSE_BAR = 2e-3


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _trs(t=(0, 0, 0), ry=0.0, s=(1, 1, 1)):
    """T * R_y * S, the CLI / glTF composition order (main.cpp:159-165)."""
    c, sn = np.cos(ry), np.sin(ry)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (
        np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
        @ np.diag(np.asarray(s, np.float32))
    )
    m[:3, 3] = t
    return m


def _soup_prim(n_tris, material, seed=0, extent=0.35):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5, 0.5, (n_tris, 1, 3))
    verts = (centers + rng.uniform(-extent, extent, (n_tris, 3, 3))).astype(np.float32)
    pos = verts.reshape(-1, 3)
    e1 = pos[1::3] - pos[0::3]
    e2 = pos[2::3] - pos[0::3]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    nrm = np.repeat(n, 3, axis=0).astype(np.float32)
    nv = pos.shape[0]
    return Primitive(
        positions=pos,
        normals=nrm,
        tangents=np.zeros((nv, 4), np.float32),
        uvs=np.zeros((nv, 2), np.float32),
        indices=np.arange(nv, dtype=np.uint32),
        material=material,
    )


def _quad_prim(material, half=0.5):
    pos = np.array(
        [[-half, 0, -half], [half, 0, -half], [half, 0, half], [-half, 0, half]],
        np.float32,
    )
    nrm = np.tile(np.array([0, -1, 0], np.float32), (4, 1))
    return Primitive(
        positions=pos,
        normals=nrm,
        tangents=np.zeros((4, 4), np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        indices=np.array([0, 2, 1, 0, 3, 2], np.uint32),
        material=material,
    )


def _instanced_scene(n_soup_instances=5, soup_tris=120):
    """Shared soup prototype x N instances + floor + 2 emissive instances."""
    s = Scene()
    grey = Material()
    grey.metallic_factor = 0.0
    grey.roughness_factor = 0.8
    red = Material()
    red.base_colour_factor = np.array([0.8, 0.25, 0.2, 1.0], np.float32)
    red.metallic_factor = 0.0
    light = Material()
    light.emissive_factor = np.array([12.0, 11.0, 10.0], np.float32)
    light.metallic_factor = 0.0
    s.materials += [grey, red, light]

    s.mesh_pool.append([_soup_prim(soup_tris, material=1, seed=3)])
    s.mesh_pool.append([_quad_prim(material=2)])  # emissive panel, faces -y
    # floor: big quad facing +y at y=-1
    floor = _quad_prim(material=0, half=6.0)
    floor.normals = -floor.normals
    floor.indices = floor.indices[::-1].copy()
    s.mesh_pool.append([floor])

    rng = np.random.default_rng(9)
    for i in range(n_soup_instances):
        t = (float(2.2 * (i % 3) - 2.2), float(0.0), float(-1.5 * (i // 3)))
        sc = float(rng.uniform(0.6, 1.5))
        s.add_node(s.root, _trs(t, ry=float(rng.uniform(0, 6.28)), s=(sc, sc * 0.7, sc)), mesh=0)
    s.add_node(s.root, _trs((0.0, 2.5, 0.0), s=(2.0, 1.0, 2.0)), mesh=1)
    s.add_node(s.root, _trs((-2.0, 3.0, -1.0), ry=0.7), mesh=1)
    s.add_node(s.root, _trs((0.0, -1.0, 0.0)), mesh=2)
    return s


def _cam():
    return Camera(
        position=np.array([0.0, 1.2, 5.0]), direction=np.array([0.0, -0.25, -1.0])
    )


@pytest.mark.slow
def test_instanced_upload_is_o_tris_plus_instances():
    """100 instances of one prototype upload prototype-sized columns."""
    s = Scene()
    m = Material()
    m.metallic_factor = 0.0
    s.materials.append(m)
    s.mesh_pool.append([_soup_prim(2000, material=0)])
    for i in range(100):
        s.add_node(s.root, _trs((i % 10, 0, i // 10)), mesh=0)
    t = s.upload(instancing=True)
    assert t.inst is not None
    assert t.num_triangles == 2000  # prototype columns, NOT 200,000
    assert t.inst.num_instances == 100
    assert len(t.inst.groups) == 1
    assert int(t.inst.groups[0].inst_id.shape[0]) == 100
    # flattening the same scene allocates 100x the triangle columns
    tf = s.upload(instancing=False)
    assert tf.num_triangles == 200_000


@pytest.mark.slow
def test_instanced_render_matches_flattened():
    """Same scene, both uploads, shared RNG -> same image (fp tolerance)."""
    s = _instanced_scene()
    tf = s.upload(instancing=False)
    ti = s.upload(instancing=True)
    assert tf.num_triangles == 5 * 120 + 2 * 2 + 2
    assert ti.num_triangles == 120 + 2 + 2 and ti.inst.num_instances == 8
    a, _ = render_image(tf, _cam(), 32, 32, spp=2, max_depth=3, tonemap=False)
    b, _ = render_image(ti, _cam(), 32, 32, spp=2, max_depth=3, tonemap=False)
    assert a.mean() > 1e-3  # lit
    r = _rmse(a, b)
    assert r < RMSE_BAR, f"instanced vs flattened RMSE {r}"


def test_instanced_emissive_cdf_covers_instances():
    """Each emissive instance gets its own CDF rows with world-space area
    (the reference's latent per-instance emissive overwrite, scene.cpp:384-392,
    resolved the same way the flattened path does)."""
    s = _instanced_scene()
    ti = s.upload(instancing=True)
    assert ti.num_emissive_tris == 4  # 2 panel instances x 2 triangles
    cdf = np.asarray(ti.em_cdf)
    assert cdf.shape == (4,) and abs(cdf[-1] - 1.0) < 1e-6
    # the first panel instance is scaled 2x in x/z -> 4x the area share
    p = np.diff(np.concatenate([[0.0], cdf]))
    assert p[:2].sum() > 2.5 * p[2:].sum()


@pytest.mark.slow
def test_instanced_refit_moves_instances():
    """refit() updates transforms in O(instances); matches a fresh upload."""
    s = _instanced_scene(n_soup_instances=3)
    ti = s.upload(instancing=True)
    # move one soup instance freely and one emissive panel RIGIDLY: refit
    # keeps the upload-time CDF/areas (reference update() parity,
    # scene.cpp:281-342), so an emissive move must preserve area for a
    # fresh upload to be comparable
    nodes = [n for n in s.iter_depth_first() if n.mesh >= 0]
    nodes[0].world_transform = _trs((0.5, 0.4, -0.3), ry=0.5)
    panel = nodes[-2]
    assert s.materials[s.mesh_pool[panel.mesh][0].material].is_emissive
    panel.world_transform = _trs((1.0, 2.8, 0.5), ry=0.9) @ panel.world_transform
    moved = s.refit(ti)
    fresh = s.upload(instancing=True)
    a, _ = render_image(moved, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    b, _ = render_image(fresh, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    assert _rmse(a, b) < RMSE_BAR
    # and the move actually changed the image vs the original tables
    c, _ = render_image(ti, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    assert _rmse(a, c) > 1e-4


@pytest.mark.slow
def test_instanced_alpha_mask_texture():
    """MASK alpha with a texture through the encoded-id resample loop."""
    s = Scene()
    back = Material()
    back.metallic_factor = 0.0
    mask = Material()
    mask.metallic_factor = 0.0
    mask.alpha_mode = 1
    mask.alpha_cutoff = 0.5
    mask.base_colour_tex = 0
    light = Material()
    light.emissive_factor = np.array([8.0, 8.0, 8.0], np.float32)
    s.materials += [back, mask, light]
    tex = np.ones((4, 4, 4), np.float32)
    xx, yy = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    tex[..., 3] = np.where((xx + yy) % 2 == 0, 1.0, 0.1)
    s.textures.append(tex)

    def vquad(mat):  # vertical quad facing +z
        p = _quad_prim(mat)
        pos = p.positions.copy()
        pos[:, [1, 2]] = pos[:, [2, 1]]
        p.positions = pos
        p.normals = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
        return p

    s.mesh_pool.append([vquad(1)])  # masked quad prototype
    s.mesh_pool.append([vquad(0)])  # backdrop
    s.mesh_pool.append([_quad_prim(2)])  # light
    s.add_node(s.root, _trs((0, 0, 0.5)), mesh=0)
    s.add_node(s.root, _trs((0.3, 0, 0.2), s=(1.2, 1.2, 1.0)), mesh=0)
    s.add_node(s.root, _trs((0, 0, -0.5), s=(4, 4, 1)), mesh=1)
    s.add_node(s.root, _trs((0, 2.0, 0.5)), mesh=2)

    tf = s.upload(instancing=False)
    ti = s.upload(instancing=True)
    assert ti.has_alpha and ti.inst is not None
    cam = Camera(position=np.array([0.0, 0.0, 3.0]), direction=np.array([0.0, 0.0, -1.0]))
    a, _ = render_image(tf, cam, 32, 32, spp=2, max_depth=3, tonemap=False)
    b, _ = render_image(ti, cam, 32, 32, spp=2, max_depth=3, tonemap=False)
    assert a.mean() > 1e-4
    assert _rmse(a, b) < RMSE_BAR


def test_auto_policy(monkeypatch):
    """'auto' flattens small scenes; instanced when large AND duplicated."""
    from vulkan_raytracer.scene import scenegraph as sg

    s = _instanced_scene()
    assert not s._should_instance("auto")  # small scene: flatten
    monkeypatch.setattr(sg, "INSTANCE_AUTO_MIN_FLATTENED", 500)
    assert s._should_instance("auto")  # duplication dominates
    monkeypatch.setenv("VKRT_INSTANCING", "0")
    assert not s._should_instance("auto")
    monkeypatch.setenv("VKRT_INSTANCING", "1")
    assert s._should_instance("auto")


@pytest.mark.slow
def test_instanced_big_prototype_blas_branch(monkeypatch):
    """Prototypes above DENSE_MAX_TRIS walk a per-prototype threaded BLAS
    inside the instance scan; forced here by shrinking the threshold."""
    from vulkan_raytracer.scene import scenegraph as sg

    s = _instanced_scene(n_soup_instances=4)
    tf = s.upload(instancing=False)
    monkeypatch.setattr(sg, "DENSE_MAX_TRIS", 50)  # soup prototype: 120 tris
    ti = s.upload(instancing=True)
    assert ti.inst.groups[0].blas is not None  # the soup group
    assert ti.inst.groups[1].blas is None  # 2-tri panel stays dense
    a, _ = render_image(tf, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    b, _ = render_image(ti, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    assert a.mean() > 1e-3
    assert _rmse(a, b) < RMSE_BAR


@pytest.mark.slow
def test_instanced_big_prototype_packet_blas(monkeypatch):
    """On the GPU the big-prototype BLAS walk runs the BVH kernel
    (ops/instanced.py); driven here in interpret mode and pinned against
    the flattened renderer like the reference-walk branch."""
    import jax

    from vulkan_raytracer.ops import bvh_kernel
    from vulkan_raytracer.scene import scenegraph as sg

    s = _instanced_scene(n_soup_instances=4)
    tf = s.upload(instancing=False)
    monkeypatch.setattr(sg, "DENSE_MAX_TRIS", 50)  # soup prototype: 120 tris
    ti = s.upload(instancing=True)
    assert ti.inst.groups[0].blas is not None
    assert ti.inst.groups[1].blas is None
    jax.clear_caches()
    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: "interpret")
    a, _ = render_image(tf, _cam(), 16, 16, spp=2, max_depth=2, tonemap=False)
    b, _ = render_image(ti, _cam(), 16, 16, spp=2, max_depth=2, tonemap=False)
    assert a.mean() > 1e-3
    assert _rmse(a, b) < RMSE_BAR


@pytest.mark.slow
def test_instanced_windowed_blas_matches_plain(monkeypatch):
    """Instanced BLAS prototypes walked by the BVH kernel (interpret mode)
    match the plain XLA reference walk on the identical instanced scene.
    (Reference bar: instanced TLAS traversal shares the ordered hardware
    walk, accelerationstructure.cpp:157-177.)"""
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer.ops import bvh_kernel
    from vulkan_raytracer.ops.instanced import (
        instanced_closest,
        instanced_shadow,
    )
    from vulkan_raytracer.ops.math3 import V3
    from vulkan_raytracer.scene import scenegraph as sg

    monkeypatch.setattr(sg, "DENSE_MAX_TRIS", 50)  # soup prototype: 120 tris
    ti = _instanced_scene(n_soup_instances=4).upload(instancing=True)
    assert ti.inst.groups[0].blas is not None
    jax.clear_caches()
    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: "interpret")

    rng = np.random.default_rng(11)
    n = 256
    # rays from a shell around the instance field, aimed inward with jitter
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack(
        [4.5 * np.cos(ang), rng.uniform(-0.5, 2.5, n), 4.5 * np.sin(ang) - 0.7],
        axis=1,
    ).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    act = jnp.asarray(np.arange(n) % 5 != 0)

    def closest():
        return instanced_closest(ti, ov, dv, t_min=1e-3, t_max=1e32, active=act)

    def shadow():
        return instanced_shadow(ti, ov, dv, t_max=2.5, active=act)

    tw, ew, uw, vw = closest()
    ow = shadow()
    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: None)
    tp, ep, up, vp = closest()
    op = shadow()

    ew_n, ep_n = np.asarray(ew), np.asarray(ep)
    hit = ew_n >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(hit, ep_n >= 0)
    np.testing.assert_allclose(np.asarray(tw)[hit], np.asarray(tp)[hit], rtol=1e-6)
    same = ew_n == ep_n  # ties at equal t may pick either triangle
    assert same[hit].mean() > 0.999
    np.testing.assert_allclose(
        np.asarray(uw)[hit & same], np.asarray(up)[hit & same], atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(ow), np.asarray(op))
    assert np.asarray(ow).any()
