"""Feature-coverage tests: analytic lights, skybox, textures, GLB, CLI."""

import numpy as np
import jax.numpy as jnp
import pytest

from vulkan_raytracer.render import oracle
from vulkan_raytracer.render.renderer import render_image
from vulkan_raytracer.scene.builtin import _add_primitive, _quad, cornell_box_scene
from vulkan_raytracer.scene.camera import Camera
from vulkan_raytracer.scene.scenegraph import (
    DirectionalLight,
    Material,
    PointLight,
    Scene,
)

CAM = dict(position=np.array([0.0, 1.0, 3.0]), direction=np.array([0.0, 0.0, -1.0]))


def floor_scene() -> Scene:
    s = Scene()
    m = Material()
    m.base_colour_factor = np.array([0.8, 0.8, 0.8, 1.0], np.float32)
    m.metallic_factor = 0.0
    m.roughness_factor = 0.7
    _add_primitive(s, *_quad([-5, 0, 5], [5, 0, 5], [5, 0, -5], [-5, 0, -5]), m)
    return s


@pytest.mark.slow
def test_point_light_matches_oracle_and_inverse_square():
    s = floor_scene()
    s.point_lights.append(
        PointLight(np.array([0, 2, 0], np.float32), np.ones(3, np.float32), 10.0, 0.0)
    )
    t = s.upload()
    assert t.num_point == 1
    cam = Camera(**{k: v.copy() for k, v in CAM.items()})
    img, _ = render_image(t, cam, 24, 24, spp=4, max_depth=2, tonemap=False)
    ref = oracle.render_image(t, cam, 24, 24, spp=4, max_depth=2)
    assert np.sqrt(np.mean((img - ref) ** 2)) < 2e-3
    assert img.mean() > 1e-2  # lit by the point light


@pytest.mark.slow
def test_point_light_range_attenuation():
    """range!=0 windows the light (lightsample.glsl:31-33)."""
    def render_with_range(rng_val):
        s = floor_scene()
        s.point_lights.append(
            PointLight(np.array([0, 2, 0], np.float32), np.ones(3, np.float32), 10.0, rng_val)
        )
        cam = Camera(**{k: v.copy() for k, v in CAM.items()})
        img, _ = render_image(s.upload(), cam, 16, 16, spp=2, max_depth=1, tonemap=False)
        return img

    unbounded = render_with_range(0.0)
    windowed = render_with_range(2.1)  # barely reaches the floor
    assert windowed.mean() < unbounded.mean()


@pytest.mark.slow
def test_directional_light_matches_oracle():
    s = floor_scene()
    s.directional_lights.append(
        DirectionalLight(
            np.array([0, -1, 0], np.float32) / 1.0, np.ones(3, np.float32), 3.0
        )
    )
    t = s.upload()
    assert t.num_directional == 1
    cam = Camera(**{k: v.copy() for k, v in CAM.items()})
    img, _ = render_image(t, cam, 24, 24, spp=4, max_depth=2, tonemap=False)
    ref = oracle.render_image(t, cam, 24, 24, spp=4, max_depth=2)
    assert np.sqrt(np.mean((img - ref) ** 2)) < 2e-3
    assert img.mean() > 1e-2


@pytest.mark.slow
def test_mixed_analytic_and_emissive_strategies():
    """Both strategies present -> 50/50 pick with pdf /2 (lightsample.glsl:150,161)."""
    s = cornell_box_scene()
    s.point_lights.append(
        PointLight(np.array([0, 1.0, 0], np.float32), np.ones(3, np.float32), 2.0, 0.0)
    )
    t = s.upload()
    cam = Camera(**{k: v.copy() for k, v in CAM.items()})
    img, _ = render_image(t, cam, 24, 24, spp=4, max_depth=2, tonemap=False)
    ref = oracle.render_image(t, cam, 24, 24, spp=4, max_depth=2)
    assert np.sqrt(np.mean((img - ref) ** 2)) < 2e-3


@pytest.mark.slow
def test_skybox_equirect_lighting():
    """Miss lanes sample the environment (skybox.rmiss); a bright synthetic
    sky illuminates the floor through bounced rays and shows in misses."""
    s = floor_scene()
    sky = np.zeros((8, 16, 3), np.float32)
    sky[:4] = [2.0, 1.0, 0.5]  # bright "upper" hemisphere band
    s.skybox = sky
    s.skybox_strength = 1.0
    t = s.upload()
    cam = Camera(position=np.array([0.0, 1.0, 3.0]), direction=np.array([0.0, 0.3, -1.0]))
    img, _ = render_image(t, cam, 24, 24, spp=4, max_depth=2, tonemap=False)
    ref = oracle.render_image(t, cam, 24, 24, spp=4, max_depth=2)
    assert np.sqrt(np.mean((img - ref) ** 2)) < 2e-3
    assert img.max() > 0.5  # sky visible
    # strength scales it (raytracer CLI --skybox-strength)
    s.skybox_strength = 0.0
    t0 = s.upload()
    img0, _ = render_image(t0, cam, 24, 24, spp=2, max_depth=2, tonemap=False)
    assert img0.max() < img.max()


def test_glb_container(tmp_path):
    """GLB round trip: re-pack the Cornell glTF as GLB and load it."""
    import base64
    import json
    import struct

    from vulkan_raytracer.scene.gltf import GLTF

    src = json.load(open("/root/reference/res/CornellBox.gltf"))
    uri = src["buffers"][0]["uri"]
    blob = base64.b64decode(uri.split(",", 1)[1])
    del src["buffers"][0]["uri"]
    js = json.dumps(src).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    glb = (
        struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(blob))
        + struct.pack("<I4s", len(js), b"JSON")
        + js
        + struct.pack("<I4s", len(blob), b"BIN\x00")
        + blob
    )
    p = tmp_path / "cornell.glb"
    p.write_bytes(glb)
    s = Scene()
    s.load_model(p)
    t = s.upload()
    assert t.num_triangles == 32 and t.num_emissive_tris == 2


def test_cli_parsing_matches_reference_semantics():
    from vulkan_raytracer.cli import build_parser, compose_transform

    p = build_parser()
    a = p.parse_args(
        ["-r", "64,48", "-b", "3", "-t", "1,2,3", "-o", "d", "-s", "2,2,2",
         "-c", "0,1,3", "--spp", "4"]
    )
    assert a.resolution == (64, 48) and a.max_ray_depth == 3
    # T*R*S order (main.cpp:159-165): scale first, then translate
    m = compose_transform((2, 2, 2), (1, 0, 0, 0), (1, 2, 3))
    np.testing.assert_allclose(m @ np.array([1, 0, 0, 1.0]), [3, 2, 3, 1], atol=1e-6)
    # default resolution sentinel
    a2 = p.parse_args(["-r", "d"])
    assert a2.resolution == (800, 600)


def test_skybox_default_on_parity(tmp_path, monkeypatch):
    """Skybox defaults ON like args::ImplicitValueFlag, consumed
    unconditionally (main.cpp:138-139,167): absence of --skybox still
    resolves hilly_terrain_01_4k.hdr through the resource search path —
    loaded when present, warn-and-continue when absent."""
    from vulkan_raytracer.cli import DEFAULT_SKYBOX, build_parser, load_scene
    from vulkan_raytracer.utils.image import write_hdr

    p = build_parser()
    a = p.parse_args(["-m", "cornell", "--spp", "1"])
    assert a.skybox == DEFAULT_SKYBOX  # default-on, not None

    # asset missing: warn-and-continue, no environment
    monkeypatch.chdir(tmp_path)
    s = load_scene(a)
    assert s.skybox is None

    # asset present in the resource dir: picked up with no flag at all
    res = tmp_path / "res"
    res.mkdir()
    write_hdr(str(res / DEFAULT_SKYBOX),
              np.full((4, 8, 3), 0.25, np.float32))
    s2 = load_scene(p.parse_args(["-m", "cornell"]))
    assert s2.skybox is not None and s2.skybox.shape == (4, 8, 3)

    # explicit off switch
    s3 = load_scene(p.parse_args(["-m", "cornell", "--no-skybox"]))
    assert s3.skybox is None


def test_multi_model_composition(tmp_path):
    """Two Cornell boxes side by side via per-model transforms (main.cpp:159)."""
    s = Scene()
    s.load_model("/root/reference/res/CornellBox.gltf")
    from vulkan_raytracer.cli import compose_transform

    s.load_model(
        "/root/reference/res/CornellBox.gltf",
        compose_transform((1, 1, 1), (1, 0, 0, 0), (3.0, 0, 0)),
    )
    t = s.upload()
    assert t.num_triangles == 64 and t.num_emissive_tris == 4
    x = np.asarray(t.v0.x)
    assert x.max() > 2.0  # second copy translated


@pytest.mark.slow
def test_textured_material_modulation():
    """baseColour texture modulates the factor (hit.rchit:77-79)."""
    s = floor_scene()
    # checkerboard texture on the floor material
    tex = np.zeros((8, 8, 4), np.float32)
    tex[::2, ::2] = tex[1::2, 1::2] = 1.0
    tex[..., 3] = 1.0
    s.textures.append(tex)
    s.materials[0].base_colour_tex = 0
    # give the floor quad UVs spanning the texture
    prim = s.mesh_pool[0][0]
    prim.uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    s.point_lights.append(
        PointLight(np.array([0, 3, 0], np.float32), np.ones(3, np.float32), 20.0, 0.0)
    )
    t = s.upload()
    assert t.has_textures
    cam = Camera(position=np.array([0.0, 2.0, 2.0]), direction=np.array([0.0, -0.8, -0.8]))
    img, _ = render_image(t, cam, 32, 32, spp=4, max_depth=1, tonemap=False)
    lum = img.mean(-1)
    lit = lum[lum > 1e-4]
    # checker pattern -> strongly bimodal brightness on the floor
    assert lit.size > 50
    assert (lum > np.median(lit) * 3).sum() > 10


@pytest.mark.slow
def test_physical_nee_weighting_brightens_direct_light():
    """'physical' NEE weighting removes the reference's estimator quirk
    (raygen.rgen:54-83 scales NEE by the hit's own BSDF sample); the
    corrected image must be strictly brighter on lit diffuse surfaces."""
    tables = cornell_box_scene().upload()
    cam = Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))
    from vulkan_raytracer.render.renderer import render_image as ri

    ref, _ = ri(tables, cam, 24, 24, spp=4, max_depth=2, tonemap=False)
    phys, _ = ri(
        tables, cam, 24, 24, spp=4, max_depth=2, tonemap=False,
        nee_weighting="physical",
    )
    assert phys.mean() > ref.mean() * 1.05
    assert np.isfinite(phys).all()


@pytest.mark.slow
def test_checkpoint_resume_matches_straight_render(tmp_path):
    """2 spp + resumed 2 spp == straight 4 spp (same sample indices)."""
    import numpy as np

    from vulkan_raytracer import cli
    from vulkan_raytracer.utils.image import read_png

    common = ["-m", "cornell", "-r", "20,16", "-b", "2", "-c", "0,1,2.4"]
    ck = str(tmp_path / "state.npz")
    cli.main(common + ["--spp", "2", "--checkpoint", ck,
                       "--output", str(tmp_path / "a.png")])
    cli.main(common + ["--spp", "2", "--resume", ck,
                       "--output", str(tmp_path / "b.png")])
    cli.main(common + ["--spp", "4", "--output", str(tmp_path / "c.png")])
    b = read_png((tmp_path / "b.png").read_bytes()).astype(np.int32)
    c = read_png((tmp_path / "c.png").read_bytes()).astype(np.int32)
    # identical sample set; only f32 summation order differs
    assert np.abs(b - c).max() <= 1


@pytest.mark.slow
def test_resume_rejects_mismatched_shape(tmp_path):
    import pytest as _pytest

    from vulkan_raytracer import cli

    ck = str(tmp_path / "state.npz")
    cli.main(["-m", "cornell", "-r", "20,16", "-b", "2", "--spp", "1",
              "--checkpoint", ck, "--output", str(tmp_path / "a.png")])
    with _pytest.raises(SystemExit):
        cli.main(["-m", "cornell", "-r", "16,16", "-b", "2", "--spp", "1",
                  "--resume", ck, "--output", str(tmp_path / "b.png")])


def test_resume_rejects_mismatched_camera_and_settings(tmp_path):
    """Fingerprint check: same shape/depth but a moved camera or a
    different NEE estimator must refuse to blend accumulations."""
    import pytest as _pytest

    from vulkan_raytracer import cli

    ck = str(tmp_path / "state.npz")
    cli.main(["-m", "cornell", "-r", "20,16", "-b", "2", "--spp", "1",
              "-c", "0,1,2.4", "--checkpoint", ck,
              "--output", str(tmp_path / "a.png")])
    with _pytest.raises(SystemExit):
        cli.main(["-m", "cornell", "-r", "20,16", "-b", "2", "--spp", "1",
                  "-c", "0,1,2.0", "--resume", ck,
                  "--output", str(tmp_path / "b.png")])
    with _pytest.raises(SystemExit):
        cli.main(["-m", "cornell", "-r", "20,16", "-b", "2", "--spp", "1",
                  "-c", "0,1,2.4", "--nee-weighting", "physical",
                  "--resume", ck, "--output", str(tmp_path / "c.png")])
    with _pytest.raises(SystemExit):
        cli.main(["-m", "glass", "-r", "20,16", "-b", "2", "--spp", "1",
                  "-c", "0,1,2.4", "--resume", ck,
                  "--output", str(tmp_path / "d.png")])


@pytest.mark.slow
def test_hdr_output_shares_the_png_accumulation(tmp_path):
    """--hdr-output must come from the SAME accumulation as the PNG
    (one render per invocation), honouring --resume: hdr == acc/total."""
    import numpy as np

    from vulkan_raytracer import cli
    from vulkan_raytracer.utils.image import read_hdr

    common = ["-m", "cornell", "-r", "20,16", "-b", "2", "-c", "0,1,2.4"]
    ck = str(tmp_path / "state.npz")
    cli.main(common + ["--spp", "2", "--checkpoint", ck,
                       "--output", str(tmp_path / "a.png")])
    cli.main(common + ["--spp", "2", "--resume", ck,
                       "--checkpoint", ck,
                       "--output", str(tmp_path / "b.png"),
                       "--hdr-output", str(tmp_path / "b.hdr")])
    hdr = read_hdr(tmp_path / "b.hdr")
    acc = np.load(ck)
    mean = acc["acc"] / np.float32(int(acc["next_sample"]) - 1)
    # Radiance shared-exponent encoding quantises to ~1% relative
    assert np.allclose(hdr, mean.reshape(hdr.shape), rtol=0.02, atol=1e-3)


def test_sample_equirect_matches_numpy_oracle():
    """Flat-column EnvMap bilinear fetch == direct (H, W, 3) indexing
    (skybox.rmiss:17-29 mapping incl. the negative-v wrap)."""
    import jax.numpy as jnp

    from vulkan_raytracer.ops.texture import pack_envmap, sample_equirect

    rng = np.random.default_rng(11)
    env = rng.uniform(0.0, 4.0, (17, 31, 3)).astype(np.float32)
    d = rng.normal(size=(257, 3)).astype(np.float32)  # non-unit on purpose
    got = np.asarray(sample_equirect(pack_envmap(env), jnp.asarray(d)))

    h, w = env.shape[:2]
    u = np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5
    v = -(np.arcsin(np.clip(d[:, 1], -1.0, 1.0)) / np.pi + 0.5)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = np.mod(x0.astype(np.int64), w)
    x1i = np.mod(x0.astype(np.int64) + 1, w)
    y0i = np.mod(y0.astype(np.int64), h)
    y1i = np.mod(y0.astype(np.int64) + 1, h)
    top = env[y0i, x0i] * (1 - fx) + env[y0i, x1i] * fx
    bot = env[y1i, x0i] * (1 - fx) + env[y1i, x1i] * fx
    want = top * (1 - fy) + bot * fy
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
