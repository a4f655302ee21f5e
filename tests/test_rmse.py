"""End-to-end RMSE vs the independent NumPy oracle (BASELINE.md metric).

The quality bar from BASELINE.json: per-pixel RMSE < 2e-3 vs the CPU
reference at equal spp.  The XLA renderer and the oracle share RNG streams,
so they should agree to float32 rounding (observed ~1e-7), far inside the
bar; these tests exercise diffuse GI, emissive MIS, and the full
transmission/volume/dispersion path.
"""

import numpy as np
import pytest

from vulkan_raytracer.render import oracle
from vulkan_raytracer.render.renderer import render_image
from vulkan_raytracer.scene.builtin import cornell_box_scene, glass_sphere_scene
from vulkan_raytracer.scene.camera import Camera

RMSE_BAR = 2e-3


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_oracle_lane_chunking_is_transparent(monkeypatch):
    """The lane-chunked brute-force fold (big-scene bench quality gates)
    returns bit-identical results to the single-shot fold."""
    tables = cornell_box_scene().upload()
    sc = oracle.OracleScene(tables)
    rng = np.random.default_rng(3)
    n = 37  # deliberately not a multiple of any chunk size
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_hi = rng.uniform(0.5, 5.0, n).astype(np.float32)
    t_lo = np.float32(1e-4)  # oracle t_min is scalar (alpha loop passes one)
    ref = sc.closest(o, d, t_lo, t_hi)
    monkeypatch.setattr(oracle, "MAX_PAIRS", 5 * sc.v0.shape[0])
    got = sc.closest(o, d, t_lo, t_hi)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_cornell_matches_oracle():
    tables = cornell_box_scene().upload()
    cam = Camera(
        position=np.array([0.0, 1.0, 3.9]), direction=np.array([0.0, 0.0, -1.0])
    )
    img_j, _ = render_image(tables, cam, 32, 32, spp=2, max_depth=3, tonemap=False)
    img_o = oracle.render_image(tables, cam, 32, 32, spp=2, max_depth=3)
    r = _rmse(img_j, img_o)
    assert r < RMSE_BAR, f"RMSE {r} vs oracle exceeds bar"
    assert img_j.mean() > 1e-3  # actually lit


@pytest.mark.slow
def test_glass_sphere_matches_oracle():
    """Transmission + refraction + Beer-Lambert volume absorption."""
    tables = glass_sphere_scene(subdiv=2).upload()
    cam = Camera(
        position=np.array([0.0, 1.2, 3.0]), direction=np.array([0.0, -0.1, -1.0])
    )
    img_j, _ = render_image(tables, cam, 24, 24, spp=2, max_depth=4, tonemap=False)
    img_o = oracle.render_image(tables, cam, 24, 24, spp=2, max_depth=4)
    r = _rmse(img_j, img_o)
    assert r < RMSE_BAR, f"glass RMSE {r} vs oracle exceeds bar"


@pytest.mark.slow
def test_dispersive_glass_matches_oracle():
    """Spectral dispersion: wavelength collapse + Cauchy ior fit."""
    tables = glass_sphere_scene(subdiv=2, dispersion=0.2).upload()
    cam = Camera(
        position=np.array([0.0, 1.2, 3.0]), direction=np.array([0.0, -0.1, -1.0])
    )
    img_j, _ = render_image(tables, cam, 16, 16, spp=3, max_depth=4, tonemap=False)
    img_o = oracle.render_image(tables, cam, 16, 16, spp=3, max_depth=4)
    r = _rmse(img_j, img_o)
    assert r < RMSE_BAR, f"dispersion RMSE {r} vs oracle exceeds bar"


@pytest.mark.slow
def test_thin_glass_matches_oracle():
    tables = glass_sphere_scene(subdiv=2, thin=True).upload()
    cam = Camera(
        position=np.array([0.0, 1.2, 3.0]), direction=np.array([0.0, -0.1, -1.0])
    )
    img_j, _ = render_image(tables, cam, 16, 16, spp=2, max_depth=3, tonemap=False)
    img_o = oracle.render_image(tables, cam, 16, 16, spp=2, max_depth=3)
    assert _rmse(img_j, img_o) < RMSE_BAR


def _textured_aniso_scene(with_textures=True):
    """Floor with base+normal+MR+aniso textures, anisotropic brushed-metal
    plate, emissive-textured ceiling light — the paths the round-1 oracle
    excluded (VERDICT r1 item 8)."""
    from vulkan_raytracer.scene.scenegraph import Material, Scene

    s = Scene()

    def quad(z_or_y, horizontal, half=1.0):
        if horizontal:  # XZ plane at y
            pos = np.array(
                [[-half, z_or_y, -half], [half, z_or_y, -half],
                 [half, z_or_y, half], [-half, z_or_y, half]], np.float32)
            nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
            tan = np.tile(np.array([1, 0, 0, 1], np.float32), (4, 1))
        else:  # XY plane at z
            pos = np.array(
                [[-half, -half, z_or_y], [half, -half, z_or_y],
                 [half, half, z_or_y], [-half, half, z_or_y]], np.float32)
            nrm = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
            tan = np.tile(np.array([1, 0, 0, 1], np.float32), (4, 1))
        uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
        idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
        return pos, nrm, uv, idx, tan

    rng = np.random.default_rng(3)

    floor = Material()
    floor.base_colour_factor = np.array([0.9, 0.85, 0.8, 1.0], np.float32)
    floor.metallic_factor = 0.3
    floor.roughness_factor = 0.7
    floor.anisotropy_strength = 0.5
    floor.anisotropy_rotation = 0.3
    if with_textures:
        base_tex = np.ones((8, 8, 4), np.float32)
        base_tex[..., :3] = rng.uniform(0.2, 1.0, (8, 8, 3)).astype(np.float32)
        # normal map: smooth bumps, unit-ish normals encoded [0,1]
        nm = np.zeros((8, 8, 4), np.float32)
        ang = rng.uniform(-0.5, 0.5, (8, 8, 2)).astype(np.float32)
        nm[..., 0] = 0.5 + 0.3 * ang[..., 0]
        nm[..., 1] = 0.5 + 0.3 * ang[..., 1]
        nm[..., 2] = 0.9
        nm[..., 3] = 1.0
        mr = np.ones((4, 4, 4), np.float32)
        mr[..., 1] = rng.uniform(0.4, 1.0, (4, 4)).astype(np.float32)  # rough
        mr[..., 2] = rng.uniform(0.0, 1.0, (4, 4)).astype(np.float32)  # metal
        an = np.ones((4, 4, 4), np.float32)
        th = rng.uniform(-1.0, 1.0, (4, 4)).astype(np.float32)
        an[..., 0] = 0.5 + 0.5 * np.cos(th)
        an[..., 1] = 0.5 + 0.5 * np.sin(th)
        an[..., 2] = rng.uniform(0.3, 1.0, (4, 4)).astype(np.float32)
        floor.base_colour_tex = 0
        floor.normal_tex = 1
        floor.metallic_roughness_tex = 2
        floor.anisotropy_tex = 3
        s.textures += [base_tex, nm, mr, an]

    plate = Material()
    plate.base_colour_factor = np.array([0.95, 0.7, 0.3, 1.0], np.float32)
    plate.metallic_factor = 1.0
    plate.roughness_factor = 0.35
    plate.anisotropy_strength = 0.9
    plate.anisotropy_rotation = 1.1

    light = Material()
    light.base_colour_factor = np.array([0, 0, 0, 1], np.float32)
    light.emissive_factor = np.array([14.0, 13.0, 12.0], np.float32)
    if with_textures:
        em = np.ones((4, 4, 4), np.float32)
        em[..., :3] = rng.uniform(0.5, 1.0, (4, 4, 3)).astype(np.float32)
        light.emissive_tex = len(s.textures)
        s.textures.append(em)

    pos, nrm, uv, idx, tan = quad(0.0, True)
    s.add_raw_mesh(pos, nrm, idx, floor, uvs=uv, tangents=tan)
    pos, nrm, uv, idx, tan = quad(-0.9, False, half=0.8)
    s.add_raw_mesh(pos, nrm, idx, plate, uvs=uv, tangents=tan)
    pos, nrm, uv, idx, tan = quad(2.0, True, half=0.5)
    s.add_raw_mesh(pos[:, :], -nrm, idx[::-1].copy(), light, uvs=uv, tangents=tan)
    return s


@pytest.mark.slow
def test_anisotropy_matches_oracle():
    """Anisotropic GGX (strength+rotation factors, no textures)."""
    tables = _textured_aniso_scene(with_textures=False).upload()
    cam = Camera(
        position=np.array([0.0, 1.2, 2.2]), direction=np.array([0.0, -0.45, -1.0])
    )
    img_j, _ = render_image(tables, cam, 24, 24, spp=2, max_depth=3, tonemap=False)
    img_o = oracle.render_image(tables, cam, 24, 24, spp=2, max_depth=3)
    r = _rmse(img_j, img_o)
    assert r < RMSE_BAR, f"aniso RMSE {r} vs oracle exceeds bar"
    assert img_j.mean() > 1e-3


@pytest.mark.slow
def test_textures_normalmap_aniso_match_oracle():
    """Base/normal/MR/aniso/emissive textures through both transcriptions."""
    tables = _textured_aniso_scene(with_textures=True).upload()
    assert tables.has_textures
    cam = Camera(
        position=np.array([0.0, 1.2, 2.2]), direction=np.array([0.0, -0.45, -1.0])
    )
    img_j, _ = render_image(tables, cam, 24, 24, spp=2, max_depth=3, tonemap=False)
    img_o = oracle.render_image(tables, cam, 24, 24, spp=2, max_depth=3)
    r = _rmse(img_j, img_o)
    assert r < RMSE_BAR, f"textured RMSE {r} vs oracle exceeds bar"
    assert img_j.mean() > 1e-3
