"""Real-asset-scale importer proof (round-5 verdict item 6).

The >64k-triangle benchmark scenes are procedural stand-ins built
directly as tables; the real-file importer had only been exercised on
CornellBox.gltf (8 materials, untextured) and one 12-triangle synthetic
GLB.  This file generates IN-REPO (no fetching, gallery assets are not
redistributable) a gallery-class .glb container — the workload class of
the reference's Sponza/Dragon scenes (scene.cpp:29-243,
README.md:93-97) — with every container feature the loader supports:

  * >100k triangles across multiple parametric meshes,
  * 9 materials (PBR factors, metallic, MASK/BLEND alpha, emissive
    strength, transmission+volume+ior, anisotropy),
  * 5 embedded textures: PNG + baseline JPEG baseColour, PNG normal
    map, PNG emissive map, RGBA PNG for alpha,
  * INTERLEAVED vertex attributes (one bufferView, byteStride 32),
  * a SPARSE accessor patching a real base bufferView (§3.6.2.3),
  * u32 indices, a multi-primitive mesh, and NODE REUSE (the same
    mesh referenced by several nodes with distinct TRS transforms),

then proves load -> atlas -> BVH -> render against the independent
NumPy oracle (RMSE < 2e-3, BASELINE.md) on a small crop, and (slow
tier) times a full packet-path render at production shapes.
"""

import json
import struct

import numpy as np
import pytest

from vulkan_raytracer.render import oracle
from vulkan_raytracer.render.renderer import render_image
from vulkan_raytracer.scene.camera import Camera
from vulkan_raytracer.scene.scenegraph import Scene

from test_textured_glb import _Buf, _checker, _jpeg_bytes, _png_bytes

FLOAT, USHORT, UINT = 5126, 5123, 5125


def _grid_mesh(nu, nv, fn):
    """Parametric grid -> (pos, nrm, uv, idx) with analytic normals."""
    u = np.linspace(0.0, 1.0, nu + 1, dtype=np.float64)
    v = np.linspace(0.0, 1.0, nv + 1, dtype=np.float64)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p = fn(uu, vv)  # (nu+1, nv+1, 3)
    eps = 1e-4
    du = (fn(uu + eps, vv) - fn(uu - eps, vv)) / (2 * eps)
    dv = (fn(uu, vv + eps) - fn(uu, vv - eps)) / (2 * eps)
    n = np.cross(du, dv)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    pos = p.reshape(-1, 3).astype(np.float32)
    nrm = n.reshape(-1, 3).astype(np.float32)
    uv = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    i0 = (np.arange(nu)[:, None] * (nv + 1) + np.arange(nv)[None, :]).ravel()
    quad = np.stack([i0, i0 + nv + 1, i0 + nv + 2, i0, i0 + nv + 2, i0 + 1], -1)
    return pos, nrm, uv, quad.reshape(-1).astype(np.uint32)


def _sphere(r):
    def fn(u, v):
        th, ph = u * np.pi, v * 2 * np.pi
        return np.stack(
            [r * np.sin(th) * np.cos(ph), r * np.cos(th),
             r * np.sin(th) * np.sin(ph)], -1)
    return fn


def _torus(R, r):
    def fn(u, v):
        a, b = u * 2 * np.pi, v * 2 * np.pi
        w = R + r * np.cos(b)
        return np.stack([w * np.cos(a), r * np.sin(b), w * np.sin(a)], -1)
    return fn


def _terrain(sx, sz, h):
    def fn(u, v):
        y = h * (np.sin(3 * np.pi * u) * np.cos(4 * np.pi * v)
                 + 0.5 * np.sin(9 * np.pi * u * v + 1.0))
        return np.stack([sx * (u - 0.5), y, sz * (v - 0.5)], -1)
    return fn


def build_bigasset_glb(tmp_path, *, big=True):
    """Write the gallery-class .glb; ``big=False`` shrinks the grids for
    the cheap structural variant (same container features, ~2k tris)."""
    buf = _Buf()
    accessors, meshes, nodes = [], [], []
    s = 1.0 if big else 0.25  # grid resolution scale

    def acc(view, ctype, typ, count, **kw):
        a = {"bufferView": view, "componentType": ctype, "type": typ,
             "count": count}
        a.update(kw)
        accessors.append(a)
        return len(accessors) - 1

    def add_mesh(prims):
        meshes.append({"primitives": prims})
        return len(meshes) - 1

    def add_prim(pos, nrm, uv, idx, material, *, interleave=False,
                 sparse=False, force_u32=False):
        n = pos.shape[0]
        if interleave:
            # single bufferView, byteStride 32: pos(12) nrm(12) uv(8)
            inter = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)
            view = buf.add(inter.tobytes(), target=34962)
            buf.views[view]["byteStride"] = 32
            ap = acc(view, FLOAT, "VEC3", n, min=pos.min(0).tolist(),
                     max=pos.max(0).tolist())
            an = acc(view, FLOAT, "VEC3", n, byteOffset=12)
            at = acc(view, FLOAT, "VEC2", n, byteOffset=24)
        else:
            base = pos
            if sparse:
                # real base view + sparse patch displacing a vertex subset
                k = max(n // 16, 1)
                sel = np.arange(0, n, 16, dtype=np.uint32)[:k]
                patched = pos[sel] * 1.15
                base = pos.copy()
                vb = buf.add(base.tobytes(), target=34962)
                iv = buf.add(sel.astype(np.uint32).tobytes())
                vv = buf.add(patched.astype(np.float32).tobytes())
                final = base.copy()
                final[sel] = patched
                accessors.append({
                    "bufferView": vb, "componentType": FLOAT, "type": "VEC3",
                    "count": n, "min": final.min(0).tolist(),
                    "max": final.max(0).tolist(),
                    "sparse": {
                        "count": int(k),
                        "indices": {"bufferView": iv, "componentType": UINT},
                        "values": {"bufferView": vv},
                    },
                })
                ap = len(accessors) - 1
            else:
                vb = buf.add(base.tobytes(), target=34962)
                ap = acc(vb, FLOAT, "VEC3", n, min=pos.min(0).tolist(),
                         max=pos.max(0).tolist())
            an = acc(buf.add(nrm.tobytes(), target=34962), FLOAT, "VEC3", n)
            at = acc(buf.add(uv.tobytes(), target=34962), FLOAT, "VEC2", n)
        if force_u32 or idx.max() > 65535:
            ai = acc(buf.add(idx.astype(np.uint32).tobytes(), target=34963),
                     UINT, "SCALAR", idx.shape[0])
        else:
            ai = acc(buf.add(idx.astype(np.uint16).tobytes(), target=34963),
                     USHORT, "SCALAR", idx.shape[0])
        return {"attributes": {"POSITION": ap, "NORMAL": an,
                               "TEXCOORD_0": at}, "indices": ai,
                "material": material}

    # ---- textures ------------------------------------------------------
    png_base = _png_bytes(tmp_path, "base.png",
                          _checker(16, [0.85, 0.3, 0.2], [0.2, 0.3, 0.85]))
    jpg_u8 = (np.clip(_checker(16, [0.2, 0.7, 0.3], [0.9, 0.8, 0.2]), 0, 1)
              * 255 + 0.5).astype(np.uint8)
    jpg_base = _jpeg_bytes(jpg_u8)
    nm = np.tile(np.float32([0.55, 0.0, 0.835]) * 0.5 + 0.5, (8, 8, 1))
    png_normal = _png_bytes(tmp_path, "normal.png", nm)
    em = np.zeros((8, 8, 3), np.float32)
    em[:, :, 0] = np.linspace(0.3, 1.0, 8)[None, :]
    em[:, :, 1] = np.linspace(1.0, 0.4, 8)[:, None]
    png_em = _png_bytes(tmp_path, "emissive.png", em)
    blend_rgba = np.ones((8, 8, 4), np.float32) * [0.3, 0.8, 0.9, 0.45]
    png_blend = _png_bytes(tmp_path, "blend.png", blend_rgba)

    images = [
        {"bufferView": buf.add(png_base), "mimeType": "image/png"},
        {"bufferView": buf.add(jpg_base), "mimeType": "image/jpeg"},
        {"bufferView": buf.add(png_normal), "mimeType": "image/png"},
        {"bufferView": buf.add(png_em), "mimeType": "image/png"},
        {"bufferView": buf.add(png_blend), "mimeType": "image/png"},
    ]
    textures = [{"source": i} for i in range(len(images))]

    materials = [
        {"name": "sphere_png_nrm", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
            "roughnessFactor": 0.7}, "normalTexture": {"index": 2}},
        {"name": "torus_jpeg_metal", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 1}, "metallicFactor": 0.9,
            "roughnessFactor": 0.35}},
        {"name": "terrain", "pbrMetallicRoughness": {
            "baseColorFactor": [0.45, 0.5, 0.4, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.9}},
        {"name": "blend_glassy", "alphaMode": "BLEND",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 4},
                                  "metallicFactor": 0.0}},
        {"name": "pedestal_top", "pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.75, 0.6, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.5}},
        {"name": "pedestal_aniso", "pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.7, 0.75, 1.0], "metallicFactor": 1.0,
            "roughnessFactor": 0.3},
         "extensions": {"KHR_materials_anisotropy": {
             "anisotropyStrength": 0.8, "anisotropyRotation": 0.6}}},
        {"name": "panel_emissive", "emissiveFactor": [1, 1, 1],
         "emissiveTexture": {"index": 3},
         "pbrMetallicRoughness": {"metallicFactor": 0.0},
         "extensions": {"KHR_materials_emissive_strength": {
             "emissiveStrength": 60.0}}},
        {"name": "glass", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1], "metallicFactor": 0.0,
            "roughnessFactor": 0.05},
         "extensions": {
             "KHR_materials_transmission": {"transmissionFactor": 1.0},
             "KHR_materials_volume": {
                 "thicknessFactor": 0.4,
                 "attenuationColor": [0.9, 0.95, 1.0],
                 "attenuationDistance": 2.0},
             "KHR_materials_ior": {"ior": 1.5}}},
        {"name": "floor", "pbrMetallicRoughness": {
            "baseColorFactor": [0.65, 0.65, 0.65, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 1.0}},
    ]

    # ---- meshes --------------------------------------------------------
    def g(nu, nv):
        return max(int(nu * s), 8), max(int(nv * s), 8)

    m_sphere = add_mesh([add_prim(
        *_grid_mesh(*g(104, 104), _sphere(0.5)), 0, interleave=True)])
    m_torus = add_mesh([add_prim(
        *_grid_mesh(*g(96, 88), _torus(0.42, 0.16)), 1, force_u32=True)])
    m_terrain = add_mesh([add_prim(
        *_grid_mesh(*g(160, 160), _terrain(7.0, 7.0, 0.22)), 2)])
    m_blend = add_mesh([add_prim(
        *_grid_mesh(*g(48, 48), _sphere(0.38)), 3, sparse=True)])
    # multi-primitive mesh: pedestal top + anisotropic side bands
    top = _grid_mesh(*g(16, 16), lambda u, v: np.stack(
        [0.6 * (u - 0.5), 0.22 + 0 * u, 0.6 * (v - 0.5)], -1))
    side = _grid_mesh(*g(24, 12), lambda u, v: np.stack(
        [0.3 * np.cos(u * 2 * np.pi), 0.22 * v,
         0.3 * np.sin(u * 2 * np.pi)], -1))
    m_pedestal = add_mesh([add_prim(*top, 4), add_prim(*side, 5)])
    panel = _grid_mesh(8, 8, lambda u, v: np.stack(
        [0.8 * (u - 0.5), 0 * u, 0.8 * (v - 0.5)], -1))
    m_panel = add_mesh([add_prim(*panel, 6)])
    m_glass = add_mesh([add_prim(
        *_grid_mesh(*g(64, 64), _sphere(0.42)), 7)])
    floor = _grid_mesh(8, 8, lambda u, v: np.stack(
        [9.0 * (u - 0.5), 0 * u, 9.0 * (v - 0.5)], -1))
    m_floor = add_mesh([add_prim(*floor, 8)])

    def node(mesh, t=None, r=None, sc=None):
        nd = {"mesh": mesh}
        if t is not None:
            nd["translation"] = t
        if r is not None:
            nd["rotation"] = r
        if sc is not None:
            nd["scale"] = sc
        nodes.append(nd)

    # node REUSE: spheres/tori/blend shells each placed twice
    node(m_terrain, t=[0.0, -0.05, 0.0])
    node(m_floor, t=[0.0, -0.3, 0.0])
    node(m_sphere, t=[-1.2, 0.75, 0.2])
    node(m_sphere, t=[1.25, 0.8, -0.5], sc=[1.2, 1.2, 1.2])
    node(m_torus, t=[0.0, 0.45, 0.9],
         r=[0.0, 0.3826834, 0.0, 0.9238795])
    node(m_torus, t=[-0.2, 0.5, -1.4], sc=[0.8, 0.8, 0.8])
    node(m_blend, t=[0.85, 0.6, 0.85])
    node(m_blend, t=[-0.9, 0.55, -0.9], sc=[0.7, 0.7, 0.7])
    node(m_pedestal, t=[0.0, 0.0, 0.0])
    node(m_glass, t=[0.0, 0.75, 0.0])
    # panel normals are -y by construction (du x dv): they face the scene
    node(m_panel, t=[-1.0, 2.6, 0.3])
    node(m_panel, t=[1.4, 2.4, -0.6], sc=[0.7, 0.7, 0.7])

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "images": images,
        "textures": textures,
        "accessors": accessors,
        "bufferViews": buf.views,
        "buffers": [{"byteLength": len(buf.data)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob = buf.data + b"\x00" * (-len(buf.data) % 4)
    glb = (
        struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(blob))
        + struct.pack("<I4s", len(js), b"JSON") + js
        + struct.pack("<I4s", len(blob), b"BIN\x00") + blob
    )
    p = tmp_path / ("bigasset.glb" if big else "bigasset_small.glb")
    p.write_bytes(glb)
    return p


def _load(tmp_path, big):
    p = build_bigasset_glb(tmp_path, big=big)
    s = Scene()
    s.load_model(p)
    return s


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    s = _load(tmp_path_factory.mktemp("bigasset"), big=False)
    return s, s.upload()


def test_bigasset_structure_and_render(small_scene):
    """Container features at reduced grid scale (default tier): every
    loader path the big variant uses, plus the oracle RMSE bar."""
    s, t = small_scene

    assert len(s.materials) == 9
    assert len(s.textures) == 5
    assert t.num_emissive_tris > 0
    assert t.num_triangles >= 2000  # 12 nodes over 8 meshes (reuse)

    cam = Camera(position=np.array([0.0, 1.7, 4.6]),
                 direction=np.array([0.0, -0.28, -1.0]))
    img, _ = render_image(t, cam, 16, 16, spp=2, max_depth=3, tonemap=False)
    ref = oracle.render_image(t, cam, 16, 16, spp=2, max_depth=3)
    rmse = float(np.sqrt(np.mean((np.asarray(img) - ref) ** 2)))
    assert rmse < 2e-3, f"bigasset (small) RMSE {rmse} vs oracle"
    assert np.asarray(img).max() > 0.0


def test_bigasset_sparse_and_interleaved(small_scene):
    """The sparse patch and interleaved stride decoded correctly."""
    _, t = small_scene
    v = np.stack([np.asarray(c) for c in (t.v0.x, t.v0.y, t.v0.z)], -1)
    # sparse blend shell (the isolated scaled instance): unpatched
    # vertices on radius 0.38*0.7, patched ones 15% further out
    c1 = np.float32([-0.9, 0.55, -0.9])
    r1 = np.linalg.norm(v - c1, axis=1)
    base_r = 0.38 * 0.7
    assert (np.abs(r1 - base_r) < 2e-3).any(), "blend shell missing"
    assert (np.abs(r1 - base_r * 1.15) < 2e-3).any(), "sparse not applied"
    # interleaved sphere: vertices on radius 0.5 around its node centre
    c2 = np.float32([-1.2, 0.75, 0.2])
    r2 = np.linalg.norm(v - c2, axis=1)
    on_sphere = np.abs(r2 - 0.5) < 5e-3
    assert on_sphere.sum() > 100, "interleaved sphere not decoded"


@pytest.mark.slow
def test_bigasset_100k_full_scale(tmp_path):
    """The full >100k-triangle container through load -> atlas -> BVH ->
    packet-path render (the round-5 verdict's real-asset-scale proof)."""
    import time

    t0 = time.perf_counter()
    s = _load(tmp_path, big=True)
    t = s.upload()
    t_load = time.perf_counter() - t0
    assert t.num_triangles >= 100_000, t.num_triangles
    assert len(s.materials) == 9 and len(s.textures) == 5

    cam = Camera(position=np.array([0.0, 1.7, 4.6]),
                 direction=np.array([0.0, -0.28, -1.0]))
    t0 = time.perf_counter()
    img, rays = render_image(t, cam, 128, 128, spp=2, max_depth=3,
                             tonemap=False)
    img = np.asarray(img)
    dt = time.perf_counter() - t0
    assert img.max() > 0.0 and np.isfinite(img).all()
    print(f"bigasset 100k: {t.num_triangles} tris, load+upload {t_load:.1f}s,"
          f" 128x128x2spp render {dt:.1f}s = {rays / dt / 1e6:.3f} Mrays/s")

    # oracle bar at full scale on a tiny crop (brute force over >100k tris)
    crop, _ = render_image(t, cam, 8, 8, spp=2, max_depth=3, tonemap=False)
    ref = oracle.render_image(t, cam, 8, 8, spp=2, max_depth=3)
    rmse = float(np.sqrt(np.mean((np.asarray(crop) - ref) ** 2)))
    assert rmse < 2e-3, f"bigasset (100k) RMSE {rmse} vs oracle"
