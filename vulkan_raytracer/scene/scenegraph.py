"""Scene graph, glTF import, and flat GPU-table upload.

The JAX analogue of the reference's scene layer (src/scene.cpp,
include/scene.h): a :class:`Scene` owns a tree of :class:`SceneObject`
nodes, host-side mesh/material/light pools filled by :meth:`Scene.load_model`
(scene.cpp:23-343), and :meth:`Scene.upload` which produces the flat device
tables consumed by the integrator — the counterpart of the reference's six
SSBOs (scene.cpp:281-342) plus the acceleration structures.

Key structural deviation from the reference (deliberate): by default, at
upload time every (node, primitive) instance is flattened to world space and
assigned its own contiguous triangle range, instead of keeping shared
per-primitive geometry referenced by TLAS instances
(accelerationstructure.cpp:157-177): flattening gives a single BVH walk
(scenes dominated by duplication upload instanced instead,
:meth:`Scene._should_instance`).  This also
fixes a latent reference issue where multiple instances of one emissive
primitive overwrite each other's ``emissiveSurfaceIdx`` (scene.cpp:384-392).
Re-instancing after moving nodes = calling :meth:`Scene.upload` again
(the analogue of AccelerationStructure::rebuild, accelerationstructure.cpp:26).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.bvh import ThreadedBVH, build_bvh, refit_bvh
from ..ops.dense import DENSE_MAX_TRIS
from ..ops.instanced import InstanceGroup, InstanceTables
from ..ops.math3 import V3
from ..ops.texture import EnvMap, TextureAtlas, pack_envmap, pack_textures
from ..ops.traverse import AlphaTables, EmissivePDFTables
from ..utils import logging as log
from . import gltf as gltf_mod

_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)

#: 'auto' instancing threshold: flatten unless the world-space soup would
#: exceed this AND duplication contributes at least half of it.
INSTANCE_AUTO_MIN_FLATTENED = 1_000_000


# ---------------------------------------------------------------------------
# Host-side PODs (material.h / light.h equivalents)
# ---------------------------------------------------------------------------


@dataclass
class Material:
    """Host material mirroring include/material.h:5-18 (+ glTF defaults).

    ``emissive_factor`` has KHR_materials_emissive_strength pre-multiplied
    (material.h:9, scene.cpp:185-188).  NOTE: the reference assigns
    ``anisotropyRotation`` into ``anisotropyStrength`` (scene.cpp:224); we
    implement the evidently intended behaviour (rotation -> rotation).
    """

    base_colour_factor: np.ndarray = field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    alpha_mode: int = 0  # 0=OPAQUE 1=MASK 2=BLEND (scene.cpp:169-176)
    alpha_cutoff: float = 0.5
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    transmission_factor: float = 0.0
    thickness_factor: float = 0.0
    attenuation_coefficient: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    ior: float = 1.5
    anisotropy_strength: float = 0.0
    anisotropy_rotation: float = 0.0
    dispersion: float = 0.0
    base_colour_tex: int = -1
    metallic_roughness_tex: int = -1
    normal_tex: int = -1
    emissive_tex: int = -1
    transmission_tex: int = -1
    anisotropy_tex: int = -1

    @property
    def is_emissive(self) -> bool:
        return bool(np.any(self.emissive_factor != 0.0))


@dataclass
class PointLight:  # light.h:8-12
    position: np.ndarray
    colour: np.ndarray
    intensity: float
    range: float  # 0 = unbounded


@dataclass
class DirectionalLight:  # light.h:14-17
    direction: np.ndarray
    colour: np.ndarray
    intensity: float


@dataclass
class Primitive:
    """One glTF mesh primitive's host arrays (mesh.h:9-23 equivalent)."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32, unit (scene.cpp:104)
    tangents: np.ndarray  # (V, 4) f32, w = handedness sign, 0 if absent
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (3F,) u32
    material: int


@dataclass
class SceneObject:
    """Scene-graph node (scene.h:22-37): transform + optional mesh."""

    local_transform: np.ndarray
    world_transform: np.ndarray
    mesh: int = -1  # index into Scene.mesh_pool, -1 = none
    depth: int = 0
    parent: "SceneObject | None" = None
    children: list["SceneObject"] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material table — the device mirror of SSBO binding 6.

    Every column is a flat (M,) array (V3 = three flat arrays): per-lane
    material fetches then lower to 1-D gathers.
    """

    base_colour: V3  # (M,) rgb
    base_alpha: jax.Array  # (M,) baseColourFactor.a
    emissive: jax.Array  # (M, 3) kept 2-D for whole-table reductions
    emissive_v: V3  # (M,) rgb — the gatherable form
    metallic: jax.Array  # (M,)
    roughness: jax.Array  # (M,)
    transmission: jax.Array  # (M,)
    thin: jax.Array  # (M,) bool — thicknessFactor == 0 (hit.rchit:98)
    attenuation: V3  # (M,)
    ior: jax.Array  # (M,)
    aniso_strength: jax.Array  # (M,)
    aniso_rotation: jax.Array  # (M,)
    dispersion: jax.Array  # (M,)
    tex_idx: jax.Array  # (M, 6) i32: base/mr/normal/emissive/transmission/aniso


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Everything the integrator needs, flat on device.

    Replaces the reference's descriptor set (raytracer.cpp:148-238):
    TLAS/BLAS -> ``bvh``/``ebvh``; SSBOs 5-10 -> the arrays below; bindless
    texture array -> ``tex`` (flat packed atlas).
    Counts gate code paths statically, like specialising the pipeline.
    Per-triangle data is stored as flat (T,) component columns so every
    per-lane fetch is a fast 1-D gather.
    """

    # triangles, flattened world space, scene order — V3 of (T,) columns
    v0: V3
    v1: V3
    v2: V3
    n0: V3  # unnormalised world vertex normals
    n1: V3
    n2: V3
    tg0: V3  # world tangents (xyz)
    tg1: V3
    tg2: V3
    tg_sign: jax.Array  # (T,) tangent w of vertex 0 (hit.rchit:46)
    uv: jax.Array  # (T, 6) [u0 v0 u1 v1 u2 v2] (texture path only)
    tri_mat: jax.Array  # (T,) i32

    materials: MaterialTable
    alpha: AlphaTables  # per-tri alpha test data for traversal

    # lights (SSBOs 7-10) — V3 of (P,)/(D,) columns
    pl_pos: V3
    pl_colour: V3
    pl_intensity: jax.Array
    pl_range: jax.Array
    dl_dir: V3
    dl_colour: V3
    dl_intensity: jax.Array

    # emissive-triangle CDF (scene.cpp:450-459, normalised :288-292)
    em_cdf: jax.Array  # (Te,) cumulative, last == 1
    em_tables: EmissivePDFTables  # p_delta/area/normals for the pdf probe
    em_tri: jax.Array  # (Te,) i32 -> scene triangle id
    # emissive-local WORLD-space copies (the reference's emissive shaders
    # pull vertices through the geometry SSBO per hit, emissive.rchit:31-44;
    # here NEE reads these directly so it never depends on the global
    # triangle columns — which hold object-space prototypes under instancing)
    em_v0: V3
    em_v1: V3
    em_v2: V3
    em_uv: jax.Array  # (Te, 6) [u0 v0 u1 v1 u2 v2]
    em_mat: jax.Array  # (Te,) i32 material id

    # acceleration structures
    bvh: ThreadedBVH
    ebvh: ThreadedBVH  # emissive-only (cullMask bit-1 equivalent)

    # environment (binding 11)
    skybox: "EnvMap"  # flat equirect HDR columns, static dims
    skybox_strength: jax.Array  # () f32

    # bindless texture array (binding 12): flat RGBA8 atlas, zero padding
    tex: "TextureAtlas"

    # TLAS instancing (accelerationstructure.cpp:157-177): None when the
    # scene is flattened to world space (the fast default); when set, the
    # triangle columns above hold OBJECT-space prototypes and traversal
    # routes through ops/instanced.py.  Hit ids are then encoded
    # instance * num_proto_tris + prototype_triangle.
    inst: "InstanceTables | None"

    # static specialisation flags
    num_point: int = dataclasses.field(metadata=dict(static=True))
    num_directional: int = dataclasses.field(metadata=dict(static=True))
    num_emissive_tris: int = dataclasses.field(metadata=dict(static=True))
    has_alpha: bool = dataclasses.field(metadata=dict(static=True))
    has_blend: bool = dataclasses.field(metadata=dict(static=True))
    has_textures: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def num_triangles(self) -> int:
        return self.v0.x.shape[0]


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


def _inv_transpose3(m4: np.ndarray) -> np.ndarray:
    """Normal-transform matrix: transpose(inverse(upper3x3)) (hit.rchit:59)."""
    return np.linalg.inv(m4[:3, :3]).T.astype(np.float32)


def _decompose_rotation(m4: np.ndarray) -> np.ndarray:
    """Rotation part of a TRS matrix (scale removed; shear unsupported).

    The reference uses glm::decompose for light placement (scene.cpp:368-375);
    for the transforms the CLI and glTF produce (T*R*S) dividing out column
    norms is exact.
    """
    r = m4[:3, :3].astype(np.float64)
    norms = np.linalg.norm(r, axis=0)
    norms[norms == 0] = 1.0
    return (r / norms).astype(np.float32)


class Scene:
    """Scene graph + host pools; ``load_model`` then ``upload``.

    Mirrors the reference Scene (scene.h:39-66): multiple glTF files may be
    loaded, each under a per-model root transform (raytracer.cpp:46-47,
    main.cpp:159-165).
    """

    def __init__(self) -> None:
        self.root = SceneObject(
            np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
        )
        self.mesh_pool: list[list[Primitive]] = []
        self.materials: list[Material] = []
        self.point_lights: list[PointLight] = []
        self.directional_lights: list[DirectionalLight] = []
        self.textures: list[np.ndarray] = []  # (H, W, 4) f32 each
        self.skybox: np.ndarray | None = None  # (H, W, 3) f32
        self.skybox_strength: float = 1.0
        self.object_count = 0
        self.max_depth = 0

    # -- graph ----------------------------------------------------------

    def add_node(
        self, parent: SceneObject, local: np.ndarray, mesh: int = -1
    ) -> SceneObject:
        node = SceneObject(
            local_transform=np.asarray(local, np.float32),
            world_transform=(parent.world_transform @ local).astype(np.float32),
            mesh=mesh,
            depth=parent.depth + 1,
            parent=parent,
        )
        parent.children.append(node)
        self.object_count += 1
        self.max_depth = max(self.max_depth, node.depth)
        return node

    def add_raw_mesh(
        self,
        positions: np.ndarray,
        normals: np.ndarray,
        indices: np.ndarray,
        material: Material,
        transform: np.ndarray | None = None,
        uvs: np.ndarray | None = None,
        tangents: np.ndarray | None = None,
    ) -> None:
        """Register a raw triangle mesh as a single-primitive node.

        Programmatic analogue of loading a one-primitive glTF model; used by
        the builtin and procedural scene generators.  The material object is
        deduplicated by identity.
        """
        try:
            mat_idx = next(
                i for i, m in enumerate(self.materials) if m is material
            )
        except StopIteration:
            mat_idx = len(self.materials)
            self.materials.append(material)
        nv = positions.shape[0]
        prim = Primitive(
            positions=np.asarray(positions, np.float32),
            normals=np.asarray(normals, np.float32),
            tangents=(
                np.zeros((nv, 4), np.float32)
                if tangents is None
                else np.asarray(tangents, np.float32)
            ),
            uvs=(
                np.zeros((nv, 2), np.float32)
                if uvs is None
                else np.asarray(uvs, np.float32)
            ),
            indices=np.asarray(indices, np.uint32),
            material=mat_idx,
        )
        self.mesh_pool.append([prim])
        t = np.eye(4, dtype=np.float32) if transform is None else transform
        self.add_node(self.root, t, mesh=len(self.mesh_pool) - 1)

    def iter_depth_first(self):
        """DFS preorder over the tree without recursion.

        The iterative analogue of the reference's stackless per-depth
        iterator (scene.h:67-112); order matches processModelRecursive so
        emissive CDF rows line up.
        """
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    # -- import ----------------------------------------------------------

    def load_model(self, path: str | Path, transform: np.ndarray | None = None) -> None:
        """Import one glTF file under ``transform`` (scene.cpp:23-343)."""
        path = Path(path)
        log.info("Loading model %s", path.name)
        g = gltf_mod.GLTF.load(path)

        base_mesh = len(self.mesh_pool)
        base_material = len(self.materials)
        base_texture = len(self.textures)

        # meshes (scene.cpp:44-143)
        for mesh_i, gltf_mesh in enumerate(g.meshes):
            log.progress_bar(mesh_i + 1, len(g.meshes), text=gltf_mesh.get("name", ""))
            prims: list[Primitive] = []
            for prim in gltf_mesh.get("primitives", []):
                attrs = prim["attributes"]
                pos = g.accessor(attrs["POSITION"])[:, :3].astype(np.float32)
                nrm = g.accessor(attrs["NORMAL"])[:, :3].astype(np.float32)
                nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
                nv = pos.shape[0]
                uv = (
                    g.accessor(attrs["TEXCOORD_0"])[:, :2].astype(np.float32)
                    if "TEXCOORD_0" in attrs
                    else np.zeros((nv, 2), np.float32)
                )
                tan = (
                    g.accessor(attrs["TANGENT"]).astype(np.float32)
                    if "TANGENT" in attrs
                    else np.zeros((nv, 4), np.float32)
                )
                idx = g.primitive_indices(prim)
                mat = base_material + prim.get("material", 0)
                prims.append(Primitive(pos, nrm, tan, uv, idx, mat))
            self.mesh_pool.append(prims)

        # materials + 5 KHR extensions (scene.cpp:148-231)
        for mat_i, gm in enumerate(g.materials):
            log.progress_bar(mat_i + 1, len(g.materials), text=gm.get("name", ""))
            self.materials.append(self._parse_material(g, gm, base_texture))
        if g.meshes and not g.materials:
            self.materials.append(Material())  # default for material-less prims

        # images -> texture pool (scene.cpp:233-243)
        for img_i, img in enumerate(g.images):
            log.progress_bar(img_i + 1, len(g.images), text=img.get("uri", ""))
            self.textures.append(self._load_image(g, img))

        # punctual lights (scene.cpp:246-270); poses filled in the node walk
        light_slots: list[tuple[str, int]] = []
        for gl in g.lights:
            colour = np.asarray(gl.get("color", [1, 1, 1]), np.float32)
            intensity = float(gl.get("intensity", 1.0))
            if gl.get("type") == "point":
                light_slots.append(("point", len(self.point_lights)))
                self.point_lights.append(
                    PointLight(np.zeros(3, np.float32), colour, intensity, float(gl.get("range", 0.0)))
                )
            elif gl.get("type") == "directional":
                light_slots.append(("directional", len(self.directional_lights)))
                self.directional_lights.append(
                    DirectionalLight(np.array([0, 0, -1], np.float32), colour, intensity)
                )
            else:  # spot etc. — reference ignores them too (scene.cpp:254-268)
                light_slots.append(("unsupported", -1))

        # node walk (scene.cpp:344-404)
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        model_root = self.add_node(self.root, transform)
        for node_idx in g.scene_root_nodes():
            self._process_node(model_root, g, g.nodes[node_idx], base_mesh, light_slots)
        log.info("Finished loading model %s", path.name)

    def _parse_material(self, g: gltf_mod.GLTF, gm: dict, base_tex: int) -> Material:
        m = Material()
        pbr = gm.get("pbrMetallicRoughness", {})
        m.base_colour_factor = np.asarray(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
        )
        m.metallic_factor = float(pbr.get("metallicFactor", 1.0))
        m.roughness_factor = float(pbr.get("roughnessFactor", 1.0))

        def tex(src: dict | None) -> int:
            if not src:
                return -1
            return base_tex + g.textures[src["index"]].get("source", -1)

        m.base_colour_tex = tex(pbr.get("baseColorTexture"))
        m.metallic_roughness_tex = tex(pbr.get("metallicRoughnessTexture"))
        m.normal_tex = tex(gm.get("normalTexture"))
        m.emissive_tex = tex(gm.get("emissiveTexture"))

        m.alpha_mode = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
            gm.get("alphaMode", "OPAQUE"), 0
        )
        m.alpha_cutoff = float(gm.get("alphaCutoff", 0.5))
        m.emissive_factor = np.asarray(gm.get("emissiveFactor", [0, 0, 0]), np.float32)

        ext = gm.get("extensions", {})
        if "KHR_materials_emissive_strength" in ext:
            m.emissive_factor = m.emissive_factor * np.float32(
                ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0)
            )
        if "KHR_materials_transmission" in ext:
            tr = ext["KHR_materials_transmission"]
            m.transmission_factor = float(tr.get("transmissionFactor", 0.0))
            m.transmission_tex = tex(tr.get("transmissionTexture"))
        if "KHR_materials_volume" in ext:
            vol = ext["KHR_materials_volume"]
            m.thickness_factor = float(vol.get("thicknessFactor", 0.0))
            att_dist = float(vol.get("attenuationDistance", np.inf))
            att_col = np.asarray(vol.get("attenuationColor", [1, 1, 1]), np.float64)
            # sigma = -log(colour)/distance (scene.cpp:209)
            with np.errstate(divide="ignore"):
                m.attenuation_coefficient = (
                    -np.log(np.maximum(att_col, 1e-30)) / att_dist
                ).astype(np.float32)
        if "KHR_materials_ior" in ext:
            m.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
        if "KHR_materials_anisotropy" in ext:
            an = ext["KHR_materials_anisotropy"]
            m.anisotropy_strength = float(an.get("anisotropyStrength", 0.0))
            m.anisotropy_rotation = float(an.get("anisotropyRotation", 0.0))
            m.anisotropy_tex = tex(an.get("anisotropyTexture"))
        if "KHR_materials_dispersion" in ext:
            m.dispersion = float(ext["KHR_materials_dispersion"].get("dispersion", 0.0))
        return m

    def _load_image(self, g: gltf_mod.GLTF, img: dict) -> np.ndarray:
        from ..utils import image as image_io

        uri = img.get("uri")
        try:
            if uri and not uri.startswith("data:"):
                return image_io.load_texture(g.base_dir / uri)
            if uri:  # data URI
                import base64 as _b64

                _, b64 = uri.split(",", 1)
                return image_io.decode_texture(_b64.b64decode(b64))
            bv = g.doc["bufferViews"][img["bufferView"]]
            buf = g.buffers[bv["buffer"]]
            off = bv.get("byteOffset", 0)
            return image_io.decode_texture(buf[off : off + bv["byteLength"]])
        except Exception as e:  # keep loading; sample as white
            log.error("Failed to load image %s: %s", uri or "<bufferView>", e)
            return np.ones((1, 1, 4), np.float32)

    def _process_node(self, parent, g, node, base_mesh, light_slots) -> None:
        local = gltf_mod.node_local_transform(node)
        so = self.add_node(
            parent, local, base_mesh + node["mesh"] if "mesh" in node else -1
        )
        world = so.world_transform

        light = g.node_light(node)
        if light >= 0 and light < len(light_slots):
            kind, idx = light_slots[light]
            if kind == "point":
                self.point_lights[idx].position = world[:3, 3].copy()
            elif kind == "directional":
                rot = _decompose_rotation(world)
                self.directional_lights[idx].direction = (
                    rot @ np.array([0, 0, -1], np.float32)
                ).astype(np.float32)

        for child in node.get("children", []):
            self._process_node(so, g, g.nodes[child], base_mesh, light_slots)

    # -- upload ------------------------------------------------------------

    def refit(self, tables: SceneTables) -> SceneTables:
        """Cheap dynamic-scene update — AccelerationStructure::update().

        Re-flattens world-space geometry after node transforms changed and
        REFITS the acceleration structures in place of a full rebuild
        (accelerationstructure.cpp:26-32): BVH/emissive-BVH topology and
        slot ordering are kept, only AABBs, triangle data and the packed
        rows refresh.  Parity note, matching the reference's update(): the
        emissive CDF / areas / light placements are NOT recomputed (the
        reference builds them once at upload, scene.cpp:281-342).
        Topology (triangle counts, mesh list, materials) must be unchanged.

        Instanced tables refit in O(instances): geometry is shared and
        object-space, so only the per-instance transforms, world AABBs,
        emissive world rows, and the emissive BVH refresh — no triangle
        re-flatten and no BLAS rebuild (the reference's BLAS update is a
        driver refit of the same buffers, accelerationstructure.cpp:135-136).
        """
        if tables.inst is not None:
            return self._refit_instanced(tables)
        v0s, v1s, v2s, n_tris, tg_tris = [], [], [], [], []
        for node in self.iter_depth_first():
            if node.mesh < 0:
                continue
            world = node.world_transform
            nrm_m = _inv_transpose3(world)
            for prim in self.mesh_pool[node.mesh]:
                idx = prim.indices.reshape(-1, 3)
                pos_w = prim.positions @ world[:3, :3].T + world[:3, 3]
                nrm_w = prim.normals @ nrm_m.T
                tan_w = prim.tangents[:, :3] @ nrm_m.T
                v0s.append(pos_w[idx[:, 0]])
                v1s.append(pos_w[idx[:, 1]])
                v2s.append(pos_w[idx[:, 2]])
                n_tris.append(np.stack([nrm_w[idx[:, k]] for k in range(3)], axis=1))
                tg_tris.append(np.stack([tan_w[idx[:, k]] for k in range(3)], axis=1))
        v0 = np.concatenate(v0s).astype(np.float32)
        v1 = np.concatenate(v1s).astype(np.float32)
        v2 = np.concatenate(v2s).astype(np.float32)
        if v0.shape[0] != tables.num_triangles:
            raise ValueError("refit requires unchanged topology; use upload()")
        tri_n = np.concatenate(n_tris).astype(np.float32)
        tri_tg = np.concatenate(tg_tris).astype(np.float32)

        bvh = refit_bvh(tables.bvh, v0, v1, v2)
        em_tri = np.asarray(tables.em_tri)
        ebvh = tables.ebvh
        if tables.num_emissive_tris > 0:
            ebvh = refit_bvh(tables.ebvh, v0[em_tri], v1[em_tri], v2[em_tri])

        def vcomp(a):
            return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        return dataclasses.replace(
            tables,
            v0=vcomp(v0),
            v1=vcomp(v1),
            v2=vcomp(v2),
            n0=vcomp(tri_n[:, 0]),
            n1=vcomp(tri_n[:, 1]),
            n2=vcomp(tri_n[:, 2]),
            tg0=vcomp(tri_tg[:, 0]),
            tg1=vcomp(tri_tg[:, 1]),
            tg2=vcomp(tri_tg[:, 2]),
            em_v0=vcomp(v0[em_tri]),
            em_v1=vcomp(v1[em_tri]),
            em_v2=vcomp(v2[em_tri]),
            bvh=bvh,
            ebvh=ebvh,
        )

    def _build_material_table(self):
        """MaterialTable + per-material alpha columns (shared by both
        upload paths)."""
        mats = self.materials or [Material()]

        def vcol(rows):  # list of (3,) -> V3 of (M,)
            a = np.stack(rows).astype(np.float32)
            return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        emissive_np = np.stack([m.emissive_factor for m in mats]).astype(np.float32)
        mt = MaterialTable(
            base_colour=vcol([m.base_colour_factor[:3] for m in mats]),
            base_alpha=jnp.asarray(
                np.array([m.base_colour_factor[3] for m in mats], np.float32)
            ),
            emissive=jnp.asarray(emissive_np),
            emissive_v=vcol([m.emissive_factor for m in mats]),
            metallic=jnp.asarray(np.array([m.metallic_factor for m in mats], np.float32)),
            roughness=jnp.asarray(np.array([m.roughness_factor for m in mats], np.float32)),
            transmission=jnp.asarray(
                np.array([m.transmission_factor for m in mats], np.float32)
            ),
            thin=jnp.asarray(np.array([m.thickness_factor == 0.0 for m in mats], bool)),
            attenuation=vcol([m.attenuation_coefficient for m in mats]),
            ior=jnp.asarray(np.array([m.ior for m in mats], np.float32)),
            aniso_strength=jnp.asarray(
                np.array([m.anisotropy_strength for m in mats], np.float32)
            ),
            aniso_rotation=jnp.asarray(
                np.array([m.anisotropy_rotation for m in mats], np.float32)
            ),
            dispersion=jnp.asarray(np.array([m.dispersion for m in mats], np.float32)),
            tex_idx=jnp.asarray(
                np.array(
                    [
                        [
                            m.base_colour_tex,
                            m.metallic_roughness_tex,
                            m.normal_tex,
                            m.emissive_tex,
                            m.transmission_tex,
                            m.anisotropy_tex,
                        ]
                        for m in mats
                    ],
                    np.int32,
                )
            ),
        )
        mode_by_mat = np.array([m.alpha_mode for m in mats], np.int32)
        aval_by_mat = np.array([m.base_colour_factor[3] for m in mats], np.float32)
        acut_by_mat = np.array([m.alpha_cutoff for m in mats], np.float32)
        return mt, mode_by_mat, aval_by_mat, acut_by_mat

    def _iter_instances(self):
        """(node, prim) pairs in DFS preorder — the reference's TLAS
        instance order (one instance per sceneObject x primitive,
        accelerationstructure.cpp:157-177)."""
        for node in self.iter_depth_first():
            if node.mesh < 0:
                continue
            for prim in self.mesh_pool[node.mesh]:
                yield node, prim

    def _should_instance(self, instancing) -> bool:
        """Decide flatten vs TLAS instancing.

        Flattening stays the default — a single BVH over world-space
        triangles is one traversal instead of two levels — but its
        memory is O(instances x triangles).  'auto' switches to instancing
        when the flattened soup would be both large in absolute terms and
        dominated by duplication.  ``VKRT_INSTANCING=0/1`` overrides.
        """
        import os

        env = os.environ.get("VKRT_INSTANCING")
        if env is not None and env != "":
            return env not in ("0", "false", "no")
        if instancing in (True, False):
            return instancing
        flat = 0
        unique = 0
        seen: set[int] = set()
        for _node, prim in self._iter_instances():
            nt = prim.indices.shape[0] // 3
            flat += nt
            if id(prim) not in seen:
                seen.add(id(prim))
                unique += nt
        return flat > INSTANCE_AUTO_MIN_FLATTENED and flat >= 2 * unique

    def upload(self, leaf_size: int = 2, instancing="auto") -> SceneTables:
        """Build all device tables (Scene::uploadResources + the AS build).

        The analogue of Scene::uploadResources (scene.cpp:281-342) plus the
        AS build (accelerationstructure.cpp:34-229), fused: one pass over
        the DFS emits world-space triangles, the emissive CDF
        (processEmissivePrimitive, scene.cpp:407-459, luminance-area
        heuristic cumulated in DFS order and normalised at the end), and
        both BVHs.

        ``instancing``: False flattens every (node, primitive) instance to
        world space (the fast default shape); True keeps shared geometry
        once with per-instance transforms (O(tris + instances) memory,
        ops/instanced.py); 'auto' flattens unless the duplication is large
        (:meth:`_should_instance`).
        """
        if self._should_instance(instancing):
            return self._upload_instanced(leaf_size)
        return self._upload_flattened(leaf_size)

    def _refit_instanced(self, tables: SceneTables) -> SceneTables:
        """O(instances) refit: new transforms + world AABBs + emissive rows."""
        inst = tables.inst
        instances = list(self._iter_instances())
        if len(instances) != inst.num_instances:
            raise ValueError("refit requires unchanged topology; use upload()")
        proto_idx, protos, tri_off, proto_aabb, num_proto_tris = (
            self._proto_registry(instances)
        )
        if num_proto_tris != inst.num_proto_tris:
            raise ValueError("refit requires unchanged topology; use upload()")
        (
            inv_rows, nrm_rows, inst_bmin, inst_bmax, members,
            _em_h, em_tri_ids, em_w,
        ) = self._instance_pass(instances, proto_idx, tri_off, proto_aabb, num_proto_tris)

        groups = tuple(
            dataclasses.replace(
                g,
                inv=jnp.asarray(inv_rows[np.array(members[p], np.int32)]),
                aabb_min=jnp.asarray(inst_bmin[np.array(members[p], np.int32)]),
                aabb_max=jnp.asarray(inst_bmax[np.array(members[p], np.int32)]),
            )
            for p, g in enumerate(inst.groups)
        )
        new_inst = dataclasses.replace(
            inst,
            groups=groups,
            inv_flat=jnp.asarray(inv_rows.T.copy()),
            nrm_flat=jnp.asarray(nrm_rows.T.copy()),
        )

        def vcomp(a):
            a = np.asarray(a, np.float32)
            return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        if tables.num_emissive_tris > 0:
            ev0 = np.concatenate([r[0] for r in em_w]).astype(np.float32)
            ev1 = np.concatenate([r[1] for r in em_w]).astype(np.float32)
            ev2 = np.concatenate([r[2] for r in em_w]).astype(np.float32)
            en = np.concatenate([r[3] for r in em_w]).astype(np.float32)
            # CDF / areas intentionally NOT recomputed (reference update()
            # parity — built once at upload, scene.cpp:281-342)
            return dataclasses.replace(
                tables,
                inst=new_inst,
                em_v0=vcomp(ev0),
                em_v1=vcomp(ev1),
                em_v2=vcomp(ev2),
                em_tables=dataclasses.replace(
                    tables.em_tables,
                    n0=jnp.asarray(en[:, 0]),
                    n1=jnp.asarray(en[:, 1]),
                    n2=jnp.asarray(en[:, 2]),
                ),
                ebvh=refit_bvh(tables.ebvh, ev0, ev1, ev2),
            )
        return dataclasses.replace(tables, inst=new_inst)

    def _instance_pass(self, instances, proto_idx, tri_off, proto_aabb, num_proto_tris):
        """One DFS pass over instances: transforms, world AABBs, emissive
        world rows.  Shared by :meth:`_upload_instanced` and the O(instances)
        instanced refit."""
        num_inst = len(instances)
        inv_rows = np.zeros((num_inst, 12), np.float32)
        nrm_rows = np.zeros((num_inst, 9), np.float32)
        inst_bmin = np.zeros((num_inst, 3), np.float32)
        inst_bmax = np.zeros((num_inst, 3), np.float32)
        members: list[list[int]] = [[] for _ in proto_aabb]
        em_heuristic: list[np.ndarray] = []
        em_tri_ids: list[np.ndarray] = []
        em_w: list[tuple] = []  # (v0, v1, v2, n, uv, mat) world rows
        corner_sel = np.array(
            [[(c >> a) & 1 for a in range(3)] for c in range(8)], np.float32
        )
        for gi, (node, prim) in enumerate(instances):
            w = node.world_transform
            inv_rows[gi] = np.linalg.inv(w.astype(np.float64))[:3, :].reshape(12)
            nrm_m = _inv_transpose3(w)
            nrm_rows[gi] = nrm_m.reshape(9)
            p = proto_idx[id(prim)]
            members[p].append(gi)
            bmin, bmax = proto_aabb[p]
            corners = bmin + corner_sel * (bmax - bmin)
            cw = corners @ w[:3, :3].T + w[:3, 3]
            inst_bmin[gi], inst_bmax[gi] = cw.min(0), cw.max(0)

            mat = self.materials[prim.material]
            if mat.is_emissive:
                idx = prim.indices.reshape(-1, 3)
                pos_w = prim.positions @ w[:3, :3].T + w[:3, 3]
                nrm_w = prim.normals @ nrm_m.T
                ev0, ev1, ev2 = (pos_w[idx[:, k]] for k in range(3))
                area = 0.5 * np.linalg.norm(np.cross(ev1 - ev0, ev2 - ev0), axis=-1)
                em_heuristic.append(
                    (area * float(mat.emissive_factor @ _LUMA)).astype(np.float32)
                )
                nt = idx.shape[0]
                enc0 = gi * num_proto_tris + tri_off[p]
                em_tri_ids.append(np.arange(enc0, enc0 + nt, dtype=np.int32))
                en = np.stack([nrm_w[idx[:, k]] for k in range(3)], axis=1)
                euv = np.stack([prim.uvs[idx[:, k]] for k in range(3)], axis=1)
                em_w.append(
                    (ev0, ev1, ev2, en, euv.reshape(nt, 6),
                     np.full(nt, prim.material, np.int32))
                )
        return (
            inv_rows, nrm_rows, inst_bmin, inst_bmax, members,
            em_heuristic, em_tri_ids, em_w,
        )

    def _proto_registry(self, instances):
        """Prototype registry in first-encounter DFS order (matches
        :meth:`_upload_instanced`'s layout; deterministic for refit)."""
        proto_idx: dict[int, int] = {}
        protos: list[Primitive] = []
        for _n, prim in instances:
            if id(prim) not in proto_idx:
                proto_idx[id(prim)] = len(protos)
                protos.append(prim)
        tri_off: list[int] = []
        proto_aabb: list[tuple[np.ndarray, np.ndarray]] = []
        off = 0
        for prim in protos:
            tri_off.append(off)
            off += prim.indices.shape[0] // 3
            proto_aabb.append((prim.positions.min(0), prim.positions.max(0)))
        return proto_idx, protos, tri_off, proto_aabb, off

    def _upload_instanced(self, leaf_size: int = 2) -> SceneTables:
        """O(tris + instances) upload: object-space prototypes + TLAS.

        The counterpart of the reference's shared-BLAS design
        (accelerationstructure.cpp:96-177): each unique glTF primitive's
        triangles are stored ONCE in object space; every (node, primitive)
        pair becomes a TLAS instance carrying a world->object transform, an
        inverse-transpose rotation for normals, and a world AABB.  Emissive
        geometry additionally gets per-instance WORLD-space rows (the
        emissive set feeds the NEE CDF, whose heuristic is world area,
        scene.cpp:450-459, and must distinguish instances — this also
        realises the reference's latent per-instance emissive fix, see the
        module docstring).  Traversal: ops/instanced.py.
        """
        instances = list(self._iter_instances())
        if not instances:
            raise ValueError("scene contains no triangles")
        proto_idx, protos, tri_off, proto_aabb, num_proto_tris = (
            self._proto_registry(instances)
        )

        # --- prototype triangle columns (OBJECT space, ops/instanced.py) --
        v0s, v1s, v2s, n_tris, tg_tris, uv_tris = [], [], [], [], [], []
        sign_tris, mat_tris = [], []
        for prim in protos:
            idx = prim.indices.reshape(-1, 3)
            pos, nrm = prim.positions, prim.normals
            tan = prim.tangents
            v0s.append(pos[idx[:, 0]])
            v1s.append(pos[idx[:, 1]])
            v2s.append(pos[idx[:, 2]])
            n_tris.append(np.stack([nrm[idx[:, k]] for k in range(3)], axis=1))
            tg_tris.append(
                np.stack([tan[idx[:, k], :3] for k in range(3)], axis=1)
            )
            uv_tris.append(np.stack([prim.uvs[idx[:, k]] for k in range(3)], axis=1))
            sign_tris.append(tan[idx[:, 0], 3])
            mat_tris.append(np.full(idx.shape[0], prim.material, np.int32))
        v0 = np.concatenate(v0s).astype(np.float32)
        v1 = np.concatenate(v1s).astype(np.float32)
        v2 = np.concatenate(v2s).astype(np.float32)
        tri_n = np.concatenate(n_tris).astype(np.float32)
        tri_tg = np.concatenate(tg_tris).astype(np.float32)
        tri_uv = np.concatenate(uv_tris).astype(np.float32)
        tri_sign = np.concatenate(sign_tris).astype(np.float32)
        tri_mat = np.concatenate(mat_tris)

        num_inst = len(instances)
        if num_inst * num_proto_tris >= 2**31:
            raise ValueError(
                f"instanced id space overflows int32: {num_inst} instances x "
                f"{num_proto_tris} prototype triangles"
            )

        # --- per-instance transforms + emissive world rows (DFS order) ---
        (
            inv_rows, nrm_rows, inst_bmin, inst_bmax, members,
            em_heuristic, em_tri_ids, em_w,
        ) = self._instance_pass(instances, proto_idx, tri_off, proto_aabb, num_proto_tris)

        # --- instance groups (one scan per prototype, ops/instanced.py) ---
        groups = []
        for p, prim in enumerate(protos):
            gl = np.array(members[p], np.int32)
            cnt = prim.indices.shape[0] // 3
            blas = None
            if cnt > DENSE_MAX_TRIS:
                s, e = tri_off[p], tri_off[p] + cnt
                blas = build_bvh(v0[s:e], v1[s:e], v2[s:e], leaf_size=leaf_size)
            groups.append(
                InstanceGroup(
                    inv=jnp.asarray(inv_rows[gl]),
                    aabb_min=jnp.asarray(inst_bmin[gl]),
                    aabb_max=jnp.asarray(inst_bmax[gl]),
                    inst_id=jnp.asarray(gl),
                    blas=blas,
                    tri_off=tri_off[p],
                    tri_cnt=cnt,
                )
            )
        inst_tables = InstanceTables(
            groups=tuple(groups),
            inv_flat=jnp.asarray(inv_rows.T.copy()),
            nrm_flat=jnp.asarray(nrm_rows.T.copy()),
            num_instances=num_inst,
            num_proto_tris=num_proto_tris,
        )

        # --- emissive CDF over WORLD-space instance rows ---
        uv_flat = tri_uv.reshape(tri_uv.shape[0], 6)
        if em_heuristic:
            h = np.concatenate(em_heuristic)
            em_tri = np.concatenate(em_tri_ids)
            cdf = np.cumsum(h, dtype=np.float64)
            total = cdf[-1] if cdf[-1] > 0 else 1.0
            cdf = (cdf / total).astype(np.float32)
            p_delta = np.diff(np.concatenate([[0.0], cdf])).astype(np.float32)
            ev0 = np.concatenate([r[0] for r in em_w]).astype(np.float32)
            ev1 = np.concatenate([r[1] for r in em_w]).astype(np.float32)
            ev2 = np.concatenate([r[2] for r in em_w]).astype(np.float32)
            en = np.concatenate([r[3] for r in em_w]).astype(np.float32)
            em_uv = np.concatenate([r[4] for r in em_w]).astype(np.float32)
            em_mat = np.concatenate([r[5] for r in em_w])
            em_area = 0.5 * np.linalg.norm(
                np.cross(ev1 - ev0, ev2 - ev0), axis=-1
            ).astype(np.float32)
            ebvh = build_bvh(ev0, ev1, ev2, leaf_size=min(leaf_size, 4))
            em_tables = EmissivePDFTables(
                p_delta=jnp.asarray(p_delta),
                area=jnp.asarray(em_area),
                n0=jnp.asarray(en[:, 0]),
                n1=jnp.asarray(en[:, 1]),
                n2=jnp.asarray(en[:, 2]),
            )
            num_em = len(em_tri)
        else:
            cdf = np.ones(1, np.float32)
            em_tri = np.zeros(1, np.int32)
            ev0 = ev1 = ev2 = np.zeros((1, 3), np.float32)
            em_uv = np.zeros((1, 6), np.float32)
            em_mat = np.zeros(1, np.int32)
            ebvh = build_bvh(ev0, ev1, ev2, leaf_size=4)
            em_tables = EmissivePDFTables(
                p_delta=jnp.zeros(1),
                area=jnp.ones(1),
                n0=jnp.ones((1, 3)),
                n1=jnp.ones((1, 3)),
                n2=jnp.ones((1, 3)),
            )
            num_em = 0

        # --- shared tables ---
        mt, mode_by_mat, aval_by_mat, acut_by_mat = self._build_material_table()
        alpha = AlphaTables(
            mode=jnp.asarray(mode_by_mat[tri_mat]),
            value=jnp.asarray(aval_by_mat[tri_mat]),
            cutoff=jnp.asarray(acut_by_mat[tri_mat]),
        )
        has_alpha = bool((mode_by_mat[tri_mat] != 0).any())
        has_blend = bool((mode_by_mat[tri_mat] == 2).any())

        # flattened structures are never traversed on the instanced path
        # (integrator gates on tables.inst first); tiny placeholders keep
        # the pytree total O(tris + instances)
        dummy = (np.zeros((1, 3), np.float32),) * 3
        bvh = build_bvh(*dummy, leaf_size=4)

        def vcomp(a):
            a = np.asarray(a, np.float32)
            return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        def light_cols(rows, default):
            return (
                np.stack(rows).astype(np.float32)
                if rows
                else np.zeros((1, len(default)), np.float32)
            )

        pls, dls = self.point_lights, self.directional_lights
        skybox = (
            self.skybox if self.skybox is not None else np.zeros((1, 1, 3), np.float32)
        )
        log.info(
            "Uploaded scene (instanced): %d prototype tris x %d instances "
            "(%d prototypes), %d emissive tris",
            num_proto_tris,
            num_inst,
            len(protos),
            num_em,
        )
        return SceneTables(
            v0=vcomp(v0),
            v1=vcomp(v1),
            v2=vcomp(v2),
            n0=vcomp(tri_n[:, 0]),
            n1=vcomp(tri_n[:, 1]),
            n2=vcomp(tri_n[:, 2]),
            tg0=vcomp(tri_tg[:, 0]),
            tg1=vcomp(tri_tg[:, 1]),
            tg2=vcomp(tri_tg[:, 2]),
            tg_sign=jnp.asarray(tri_sign),
            uv=jnp.asarray(uv_flat),
            tri_mat=jnp.asarray(tri_mat),
            materials=mt,
            alpha=alpha,
            pl_pos=vcomp(light_cols([l.position for l in pls], (0, 0, 0))),
            pl_colour=vcomp(light_cols([l.colour for l in pls], (0, 0, 0))),
            pl_intensity=jnp.asarray(
                np.array([l.intensity for l in pls], np.float32)
                if pls else np.zeros(1, np.float32)
            ),
            pl_range=jnp.asarray(
                np.array([l.range for l in pls], np.float32)
                if pls else np.zeros(1, np.float32)
            ),
            dl_dir=vcomp(light_cols([l.direction for l in dls], (0, 0, 0))),
            dl_colour=vcomp(light_cols([l.colour for l in dls], (0, 0, 0))),
            dl_intensity=jnp.asarray(
                np.array([l.intensity for l in dls], np.float32)
                if dls else np.zeros(1, np.float32)
            ),
            em_cdf=jnp.asarray(cdf),
            em_tables=em_tables,
            em_tri=jnp.asarray(em_tri),
            em_v0=vcomp(ev0),
            em_v1=vcomp(ev1),
            em_v2=vcomp(ev2),
            em_uv=jnp.asarray(em_uv),
            em_mat=jnp.asarray(em_mat),
            bvh=bvh,
            ebvh=ebvh,
            skybox=pack_envmap(skybox),
            skybox_strength=jnp.float32(self.skybox_strength),
            tex=pack_textures(self.textures),
            inst=inst_tables,
            num_point=len(pls),
            num_directional=len(dls),
            num_emissive_tris=num_em,
            has_alpha=has_alpha,
            has_blend=has_blend,
            has_textures=bool(self.textures),
        )

    def _upload_flattened(self, leaf_size: int = 2) -> SceneTables:
        """World-space flattening upload (the round-1/2 design; fast path)."""
        v0s, v1s, v2s = [], [], []
        n_tris, tg_tris, uv_tris = [], [], []
        sign_tris, mat_tris = [], []
        em_heuristic: list[np.ndarray] = []
        em_tri_ids: list[np.ndarray] = []

        tri_base = 0
        for node in self.iter_depth_first():
            if node.mesh < 0:
                continue
            world = node.world_transform
            nrm_m = _inv_transpose3(world)
            for prim in self.mesh_pool[node.mesh]:
                idx = prim.indices.reshape(-1, 3)
                pos_w = prim.positions @ world[:3, :3].T + world[:3, 3]
                nrm_w = prim.normals @ nrm_m.T
                tan_w = prim.tangents[:, :3] @ nrm_m.T
                v0s.append(pos_w[idx[:, 0]])
                v1s.append(pos_w[idx[:, 1]])
                v2s.append(pos_w[idx[:, 2]])
                n_tris.append(np.stack([nrm_w[idx[:, k]] for k in range(3)], axis=1))
                tg_tris.append(np.stack([tan_w[idx[:, k]] for k in range(3)], axis=1))
                uv_tris.append(
                    np.stack([prim.uvs[idx[:, k]] for k in range(3)], axis=1)
                )
                sign_tris.append(prim.tangents[idx[:, 0], 3])
                nt = idx.shape[0]
                mat_tris.append(np.full(nt, prim.material, np.int32))

                mat = self.materials[prim.material]
                if mat.is_emissive:
                    area = 0.5 * np.linalg.norm(
                        np.cross(
                            pos_w[idx[:, 1]] - pos_w[idx[:, 0]],
                            pos_w[idx[:, 2]] - pos_w[idx[:, 0]],
                        ),
                        axis=-1,
                    )
                    h = area * float(mat.emissive_factor @ _LUMA)
                    em_heuristic.append(h.astype(np.float32))
                    em_tri_ids.append(np.arange(tri_base, tri_base + nt, dtype=np.int32))
                tri_base += nt

        if tri_base == 0:
            raise ValueError("scene contains no triangles")

        v0 = np.concatenate(v0s).astype(np.float32)
        v1 = np.concatenate(v1s).astype(np.float32)
        v2 = np.concatenate(v2s).astype(np.float32)
        tri_n = np.concatenate(n_tris).astype(np.float32)
        tri_tg = np.concatenate(tg_tris).astype(np.float32)
        tri_uv = np.concatenate(uv_tris).astype(np.float32)
        tri_sign = np.concatenate(sign_tris).astype(np.float32)
        tri_mat = np.concatenate(mat_tris)

        mt, mode_by_mat, aval_by_mat, acut_by_mat = self._build_material_table()
        alpha = AlphaTables(
            mode=jnp.asarray(mode_by_mat[tri_mat]),
            value=jnp.asarray(aval_by_mat[tri_mat]),
            cutoff=jnp.asarray(acut_by_mat[tri_mat]),
        )
        has_alpha = bool((mode_by_mat[tri_mat] != 0).any())
        has_blend = bool((mode_by_mat[tri_mat] == 2).any())

        # emissive CDF (normalised, scene.cpp:288-292)
        if em_heuristic:
            h = np.concatenate(em_heuristic)
            em_tri = np.concatenate(em_tri_ids)
            cdf = np.cumsum(h, dtype=np.float64)
            total = cdf[-1] if cdf[-1] > 0 else 1.0
            cdf = (cdf / total).astype(np.float32)
            p_delta = np.diff(np.concatenate([[0.0], cdf])).astype(np.float32)
            ev0, ev1, ev2 = v0[em_tri], v1[em_tri], v2[em_tri]
            em_area = 0.5 * np.linalg.norm(
                np.cross(ev1 - ev0, ev2 - ev0), axis=-1
            ).astype(np.float32)
            en = tri_n[em_tri]
            ebvh = build_bvh(ev0, ev1, ev2, leaf_size=min(leaf_size, 4))
            em_tables = EmissivePDFTables(
                p_delta=jnp.asarray(p_delta),
                area=jnp.asarray(em_area),
                n0=jnp.asarray(en[:, 0]),
                n1=jnp.asarray(en[:, 1]),
                n2=jnp.asarray(en[:, 2]),
            )
            num_em = len(em_tri)
        else:  # placeholder single degenerate row; gated off statically
            cdf = np.ones(1, np.float32)
            em_tri = np.zeros(1, np.int32)
            ebvh = build_bvh(
                np.zeros((1, 3), np.float32),
                np.zeros((1, 3), np.float32),
                np.zeros((1, 3), np.float32),
                leaf_size=4,
            )
            em_tables = EmissivePDFTables(
                p_delta=jnp.zeros(1),
                area=jnp.ones(1),
                n0=jnp.ones((1, 3)),
                n1=jnp.ones((1, 3)),
                n2=jnp.ones((1, 3)),
            )
            num_em = 0

        bvh = build_bvh(v0, v1, v2, leaf_size=leaf_size)

        def vcomp(a):  # (K, 3) numpy -> V3 of (K,) device columns
            a = np.asarray(a, np.float32)
            return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        def light_cols(rows, default):
            a = (
                np.stack(rows).astype(np.float32)
                if rows
                else np.zeros((1, len(default)), np.float32)
            )
            return a

        pls, dls = self.point_lights, self.directional_lights
        pl_pos = light_cols([l.position for l in pls], (0, 0, 0))
        pl_col = light_cols([l.colour for l in pls], (0, 0, 0))
        pl_int = (
            np.array([l.intensity for l in pls], np.float32) if pls else np.zeros(1, np.float32)
        )
        pl_rng = (
            np.array([l.range for l in pls], np.float32) if pls else np.zeros(1, np.float32)
        )
        dl_dir = light_cols([l.direction for l in dls], (0, 0, 0))
        dl_col = light_cols([l.colour for l in dls], (0, 0, 0))
        dl_int = (
            np.array([l.intensity for l in dls], np.float32) if dls else np.zeros(1, np.float32)
        )

        skybox = (
            self.skybox if self.skybox is not None else np.zeros((1, 1, 3), np.float32)
        )

        tex_atlas = pack_textures(self.textures)
        has_textures = bool(self.textures)

        log.info(
            "Uploaded scene: %d tris, %d materials, %d point + %d directional lights, "
            "%d emissive tris, BVH %d nodes",
            tri_base,
            max(len(self.materials), 1),
            len(pls),
            len(dls),
            num_em,
            bvh.num_nodes,
        )

        uv_flat = tri_uv.reshape(tri_uv.shape[0], 6)

        return SceneTables(
            v0=vcomp(v0),
            v1=vcomp(v1),
            v2=vcomp(v2),
            n0=vcomp(tri_n[:, 0]),
            n1=vcomp(tri_n[:, 1]),
            n2=vcomp(tri_n[:, 2]),
            tg0=vcomp(tri_tg[:, 0]),
            tg1=vcomp(tri_tg[:, 1]),
            tg2=vcomp(tri_tg[:, 2]),
            tg_sign=jnp.asarray(tri_sign),
            uv=jnp.asarray(uv_flat),
            tri_mat=jnp.asarray(tri_mat),
            materials=mt,
            alpha=alpha,
            pl_pos=vcomp(pl_pos),
            pl_colour=vcomp(pl_col),
            pl_intensity=jnp.asarray(pl_int),
            pl_range=jnp.asarray(pl_rng),
            dl_dir=vcomp(dl_dir),
            dl_colour=vcomp(dl_col),
            dl_intensity=jnp.asarray(dl_int),
            em_cdf=jnp.asarray(cdf),
            em_tables=em_tables,
            em_tri=jnp.asarray(em_tri),
            em_v0=vcomp(v0[em_tri]),
            em_v1=vcomp(v1[em_tri]),
            em_v2=vcomp(v2[em_tri]),
            em_uv=jnp.asarray(uv_flat[em_tri]),
            em_mat=jnp.asarray(tri_mat[em_tri]),
            bvh=bvh,
            ebvh=ebvh,
            skybox=pack_envmap(skybox),
            skybox_strength=jnp.float32(self.skybox_strength),
            tex=tex_atlas,
            inst=None,
            num_point=len(pls),
            num_directional=len(dls),
            num_emissive_tris=num_em,
            has_alpha=has_alpha,
            has_blend=has_blend,
            has_textures=has_textures,
        )
