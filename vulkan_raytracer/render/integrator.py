"""Wavefront path-tracing integrator — the JAX rebuild of the GLSL pipeline.

The reference's per-pixel megakernel (shaders/raygen.rgen:32-100 plus the
closest-hit/any-hit/miss stages it dispatches) becomes one jit-compiled
program over SoA ray wavefronts: every pixel is a lane, the bounce loop is a
``lax.fori_loop`` with masked termination, and each ``traceRayEXT`` becomes
an intersection launch — dense gather-free chunks for small scenes
(:mod:`vulkan_raytracer.ops.dense`), a per-ray threaded-BVH walk beyond
(:mod:`vulkan_raytracer.ops.bvh_kernel`).  All vector state is in
component form (:class:`vulkan_raytracer.ops.math3.V3`).

Algorithmic parity notes (faithful to the reference, quirks included):
* NEE runs at the *start* of the next bounce with the throughput already
  multiplied by the current hit's BSDF estimator (raygen.rgen:54-55 runs
  after line 83's ``throughput *= reflectivity`` of the previous
  iteration); we preserve that exact weighting and RNG order by sampling
  the material first and then sampling lights within one loop iteration.
* paths terminate on emissive hits, weighted against NEE by a balance
  heuristic whose light pdf comes from an any-hit probe over emissive
  geometry (raygen.rgen:64-75, shaders/emissivepdf.rahit).
* sample 0 is the fast preview: centre jitter, termination at bounce 1
  (raygen.rgen:34,64), and it is excluded from accumulation
  (raygen.rgen:95-96).
* hit position is taken as ``o + t*d`` instead of re-interpolating object
  -space positions (hit.rchit:49-57) — identical up to fp rounding, one
  gather cheaper.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from ..ops.bsdf import (
    HitInfo,
    HitMaterial,
    material_bsdf,
    material_pdf,
    sample_material,
)
from ..ops.dense import (
    DENSE_MAX_TRIS,
    dense_closest,
    dense_emissive_pdf,
    dense_shadow,
)
from ..ops.math3 import (
    BIAS,
    EPS,
    INF,
    V3,
    v3_from_tangent,
    v3_gather,
    v3_onb,
    v3_to_tangent,
)
from ..ops.bvh_kernel import bvh_closest, bvh_shadow
from ..ops.instanced import apply_normal_matrix, instanced_closest, instanced_shadow
from ..ops.gatherpack import packed_gather
from ..ops.texture import sample_bilinear, sample_equirect
from ..ops.traverse import trace_emissive_pdf

_F32 = jnp.float32


# ---------------------------------------------------------------------------
# Traversal dispatch: the per-ray BVH walk (ops/bvh_kernel.py), the dense
# fold for scenes at or below DENSE_MAX_TRIS (none by default), the
# two-level walk for instanced tables.  Static per compiled pipeline.
# ---------------------------------------------------------------------------


def _dense_ok(tables) -> bool:
    return tables.num_triangles <= DENSE_MAX_TRIS


def _repack() -> bool:
    """Coherence-sort bounce and occlusion wavefronts (opt-in,
    ``VKRT_FORCE_REPACK=1``): the sort, the shadow sort and the width
    ladder below run only under this switch."""
    return bool(os.environ.get("VKRT_FORCE_REPACK"))


def _closest_opaque(tables, o: V3, d: V3, *, t_min, t_max, active):
    """Closest hit treating every triangle as a candidate.

    Alpha semantics live in the resample loop of :func:`_closest`, so every
    traversal backend stays on its alpha-free path.  ``t_min`` may be
    per-lane.
    """
    if tables.inst is not None:  # TLAS instancing: two-level traversal
        return instanced_closest(
            tables, o, d, t_min=t_min, t_max=t_max, active=active
        )
    if _dense_ok(tables):
        return dense_closest(tables, o, d, t_min=t_min, t_max=t_max, active=active)
    return bvh_closest(tables.bvh, o, d, t_min=t_min, t_max=t_max, active=active)


def _alpha_test(tables, tri, u, v, seed, cand):
    """Any-hit alpha decision for one candidate per lane (hit.rahit:26-53).

    alpha = baseColourFactor.a x baseColourTexture.a(uv at the candidate's
    barycentrics); MASK ignores below the cutoff, BLEND ignores with
    probability 1-alpha (one rnd drawn per BLEND candidate, matching the
    reference's short-circuit evaluation).  Returns (keep, seed).
    """
    ti = jnp.maximum(tri, 0)
    if tables.inst is not None:  # encoded id -> prototype triangle
        ti, _ = tables.inst.decode(ti)
    mode = jnp.take(tables.alpha.mode, ti, axis=0)
    alpha = jnp.take(tables.alpha.value, ti, axis=0)
    acut = jnp.take(tables.alpha.cutoff, ti, axis=0)
    if tables.has_textures:
        mat_i = jnp.take(tables.tri_mat, ti, axis=0)
        tex_b = jnp.take(tables.materials.tex_idx, mat_i, axis=0)[:, 0]
        w0 = 1.0 - u - v
        uv_g = jnp.take(tables.uv, ti, axis=0)
        uv = jnp.stack(
            [
                w0 * uv_g[:, 0] + u * uv_g[:, 2] + v * uv_g[:, 4],
                w0 * uv_g[:, 1] + u * uv_g[:, 3] + v * uv_g[:, 5],
            ],
            axis=-1,
        )
        texel = sample_bilinear(tables.tex, tex_b, uv)
        alpha = jnp.where(tex_b >= 0, alpha * texel[:, 3], alpha)
    is_blend = cand & (mode == 2)
    u_rnd, seed_adv = rng.rnd(seed)
    seed = jnp.where(is_blend, seed_adv, seed)
    ignore = (cand & (mode == 1) & (alpha < acut)) | (is_blend & (u_rnd < 1.0 - alpha))
    return cand & ~ignore, seed


def _closest(tables, o: V3, d: V3, *, t_min, t_max, active, seed):
    """traceRayEXT closest-hit with any-hit alpha (hit.rahit).

    Alpha-free scenes go straight to the fast opaque traversal.  Scenes
    with MASK/BLEND materials run an accept/reject resample loop: trace the
    nearest candidate, evaluate the any-hit alpha test at it, and re-trace
    past rejected candidates.  Candidates are therefore visited in t-order
    (Vulkan leaves any-hit invocation order unspecified, so this is a
    conforming order; the RNG stream differs from a traversal-order
    interpreter only on multi-BLEND-overlap rays).
    """
    if not tables.has_alpha:
        return _closest_opaque(
            tables, o, d, t_min=t_min, t_max=t_max, active=active
        ), seed

    n = o.x.shape[0]
    init = dict(
        t_lo=jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,)),
        pending=active,
        t=jnp.full((n,), jnp.inf, jnp.float32),
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
        seed=seed,
    )

    def cond(c):
        return jnp.any(c["pending"])

    def body(c):
        t, tri, u, v = _closest_opaque(
            tables, o, d, t_min=c["t_lo"], t_max=t_max, active=c["pending"]
        )
        found = c["pending"] & (tri >= 0)
        keep, seed2 = _alpha_test(tables, tri, u, v, c["seed"], found)
        seed_n = jnp.where(c["pending"], seed2, c["seed"])
        # accepted hits commit; rejected candidates advance the lower bound
        # strictly past the candidate (ignoreIntersectionEXT equivalent)
        t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
        rejected = found & ~keep
        return dict(
            t_lo=jnp.where(rejected, t_safe * (1.0 + 4e-7) + 1e-30, c["t_lo"]),
            pending=rejected,
            t=jnp.where(keep, t, c["t"]),
            tri=jnp.where(keep, tri, c["tri"]),
            u=jnp.where(keep, u, c["u"]),
            v=jnp.where(keep, v, c["v"]),
            seed=seed_n,
        )

    out = jax.lax.while_loop(cond, body, init)
    return (out["t"], out["tri"], out["u"], out["v"]), out["seed"]


def _shadow(tables, o: V3, d: V3, *, t_max, active, seed):
    """Occlusion query with shadow.rahit alpha semantics (tMin = 0).

    Under :func:`_repack` lanes are first re-sorted by the occlusion ray's
    OWN coherence key: the wavefront arrives sorted for the *material* ray
    directions, but NEE rays point at sampled lights.  Occlusion flags and
    per-lane RNG streams travel with the lane, so the permutation is
    estimator-invariant.  ``VKRT_NO_SHADOW_SORT=1`` keeps the bounce sort
    but skips this one.
    """
    if _repack() and not os.environ.get("VKRT_NO_SHADOW_SORT"):
        n = o.x.shape[0]
        t_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
        perm = jnp.argsort(_coherence_key(tables, o, d, ~active))

        def g(x):
            return jnp.take(x, perm, axis=0)

        occ_p, seed_p = _shadow_unsorted(
            tables,
            V3(g(o.x), g(o.y), g(o.z)),
            V3(g(d.x), g(d.y), g(d.z)),
            t_max=g(t_b),
            active=g(active),
            seed=g(seed),
        )
        occ = jnp.zeros((n,), bool).at[perm].set(occ_p)
        return occ, jnp.zeros_like(seed).at[perm].set(seed_p)
    return _shadow_unsorted(tables, o, d, t_max=t_max, active=active, seed=seed)


def _shadow_unsorted(tables, o: V3, d: V3, *, t_max, active, seed):
    if not tables.has_alpha:
        if tables.inst is not None:
            return instanced_shadow(tables, o, d, t_max=t_max, active=active), seed
        if _dense_ok(tables):
            return dense_shadow(tables, o, d, t_max=t_max, active=active), seed
        return bvh_shadow(
            tables.bvh, o, d, t_max=t_max, active=active) & active, seed
    # nearest ACCEPTED hit within t_max occludes (alpha resample loop)
    (t, tri, _, _), seed = _closest(
        tables, o, d, t_min=0.0, t_max=t_max, active=active, seed=seed
    )
    return (tri >= 0) & active, seed


def _emissive_pdf(tables, o: V3, d: V3, *, t_min, active):
    if tables.num_emissive_tris <= 1024:
        return dense_emissive_pdf(tables, o, d, t_min=t_min, active=active)
    return trace_emissive_pdf(
        tables.ebvh, tables.em_tables, o.to_array(), d.to_array(), t_min=t_min,
        active=active,
    )


# ---------------------------------------------------------------------------
# Lane ordering: 32x32 pixel blocks
# ---------------------------------------------------------------------------


def _morton6(x):
    """Interleave the low 6 bits of x into every 3rd bit position."""
    x = x.astype(jnp.uint32)
    out = jnp.zeros_like(x)
    for i in range(6):
        out = out | (((x >> i) & 1) << (3 * i))
    return out


def _coherence_key(tables, o: V3, d: V3, dead):
    """(dead, direction octant, Morton cell of origin) coherence key.

    Dead lanes sort last; live lanes group by direction octant and then by
    spatial origin locality.
    """
    if tables.inst is not None:
        # instanced tables carry a placeholder flattened BVH; take the
        # world bounds from the instance AABBs instead (fused reductions)
        root_lo = functools.reduce(
            jnp.minimum, [g.aabb_min.min(0) for g in tables.inst.groups]
        )
        root_hi = functools.reduce(
            jnp.maximum, [g.aabb_max.max(0) for g in tables.inst.groups]
        )
    else:
        root_lo = tables.bvh.aabb_min[0]
        root_hi = tables.bvh.aabb_max[0]
    scale = 64.0 / jnp.maximum(root_hi - root_lo, 1e-20)

    def cell(x, k):
        c = jnp.clip((x - root_lo[k]) * scale[k], 0.0, 63.0).astype(jnp.uint32)
        return _morton6(c)

    morton = (cell(o.x, 0) << 2) | (cell(o.y, 1) << 1) | cell(o.z, 2)
    octant = (
        (d.x < 0).astype(jnp.uint32) * 4
        + (d.y < 0).astype(jnp.uint32) * 2
        + (d.z < 0).astype(jnp.uint32)
    )
    return (dead.astype(jnp.uint32) << 30) | (octant << 27) | (morton << 9)


def _sort_wavefront(tables, s):
    """Re-pack the wavefront for coherence (SURVEY §7 item 5).

    Sort lanes by :func:`_coherence_key`: one 32-bit argsort + ~17 flat
    gathers per bounce.  Lane identity travels in s["slot"].
    """
    key = _coherence_key(tables, s["origin"], s["direction"], ~s["active"])
    perm = jnp.argsort(key)

    def g(x):
        return jnp.take(x, perm, axis=0)

    out = {}
    for k, v in s.items():
        if isinstance(v, V3):
            out[k] = V3(g(v.x), g(v.y), g(v.z))
        elif k == "rays":
            out[k] = v
        else:
            out[k] = g(v)
    return out


@functools.lru_cache(maxsize=8)
def _block_order(width: int, height: int, block: int = 32):
    """Pixel permutation grouping 32x32 image blocks into consecutive lanes.

    Neighbouring lanes then trace neighbouring pixels (coherent primary
    rays within a kernel block).  Host-side NumPy — embedded as a constant
    under jit; lru_cached (callers must not mutate).  Returns (order,
    inverse).
    """
    idx = np.arange(width * height)
    px, py = idx % width, idx // width
    nbx = -(-width // block)
    key = ((py // block) * nbx + (px // block)) * (block * block) + (
        py % block
    ) * block + (px % block)
    order = np.argsort(key, kind="stable").astype(np.int32)
    inverse = np.argsort(order, kind="stable").astype(np.int32)
    return order, inverse


# ---------------------------------------------------------------------------
# Primary rays (raygen.rgen:33-43)
# ---------------------------------------------------------------------------


def generate_primary_rays(view_inv, proj_inv, width, height, sample_count, lane_idx=None):
    """Camera rays for the given pixel lanes; returns (origin V3, direction
    V3, seed).

    Seeds are TEA(pixelIdx, sampleCount) (raygen.rgen:33); jitter is the
    pixel centre on sample 0, else two rnd draws (raygen.rgen:34).
    ``lane_idx`` selects a subset of pixels (used by the multi-chip
    pixel-tile sharding); defaults to all width*height pixels.
    """
    idx = (
        jnp.arange(width * height, dtype=jnp.uint32)
        if lane_idx is None
        else lane_idx.astype(jnp.uint32)
    )
    px = (idx % jnp.uint32(width)).astype(_F32)
    py = (idx // jnp.uint32(width)).astype(_F32)
    seed = rng.tea(idx, jnp.uint32(sample_count))
    (jx, jy), seed_j = rng.rnd_square(seed)
    preview = sample_count == jnp.uint32(0)
    jx = jnp.where(preview, 0.5, jx)
    jy = jnp.where(preview, 0.5, jy)
    seed = jnp.where(preview, seed, seed_j)

    u = (px + jx) / _F32(width) * 2.0 - 1.0
    v = -((py + jy) / _F32(height) * 2.0 - 1.0)
    # target = projInverse * (d.x, d.y, 1, 1), xyz only (raygen.rgen:41)
    p = proj_inv
    tgt = V3(
        p[0, 0] * u + p[0, 1] * v + p[0, 2] + p[0, 3],
        p[1, 0] * u + p[1, 1] * v + p[1, 2] + p[1, 3],
        p[2, 0] * u + p[2, 1] * v + p[2, 2] + p[2, 3],
    ).normalized()
    m = view_inv
    direction = V3(
        m[0, 0] * tgt.x + m[0, 1] * tgt.y + m[0, 2] * tgt.z,
        m[1, 0] * tgt.x + m[1, 1] * tgt.y + m[1, 2] * tgt.z,
        m[2, 0] * tgt.x + m[2, 1] * tgt.y + m[2, 2] * tgt.z,
    ).normalized()
    origin = V3.splat((m[0, 3], m[1, 3], m[2, 3]), idx.shape)
    return origin, direction, seed


# ---------------------------------------------------------------------------
# Hit shading state (hit.rchit:31-117 + skybox.rmiss)
# ---------------------------------------------------------------------------


def eval_hit(tables, origin: V3, direction: V3, t, tri, u, v,
             sky: bool = True) -> HitInfo:
    """Build HitInfo for every lane; miss lanes get skybox emission, t=-INF.

    Under TLAS instancing ``tri`` is the encoded instance x prototype id
    (ops/instanced.py): attributes gather at prototype granularity and the
    object-space normal/tangent transform by the hit instance's
    inverse-transpose rotation, exactly the reference's per-instance
    object->world step (hit.rchit:57-60).

    ``sky=False`` leaves miss lanes' emissive BLACK instead of fetching the
    skybox: the bounce loop defers the equirect fetch (12 gathers + 2
    transcendentals per lane) to ONE post-loop evaluation — each lane
    misses at most once and its miss direction survives in the final
    wavefront state, so one fetch replaces max_depth+1 of them.
    """
    miss = tri < 0
    ti = jnp.maximum(tri, 0)
    inst_i = None
    if tables.inst is not None:
        ti, inst_i = tables.inst.decode(ti)
    w0 = 1.0 - u - v

    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    pos = origin + direction * t_safe

    # ONE row gather for all 19 per-triangle attribute scalars: stacking
    # the columns at trace time (loop-invariant; XLA hoists it) replaces
    # 19 separate 1-D gathers per bounce.  Small tables keep element
    # gathers (ops/gatherpack.py size gate).
    g = packed_gather(
        [
            tables.n0.x, tables.n0.y, tables.n0.z,
            tables.n1.x, tables.n1.y, tables.n1.z,
            tables.n2.x, tables.n2.y, tables.n2.z,
            tables.tg0.x, tables.tg0.y, tables.tg0.z,
            tables.tg1.x, tables.tg1.y, tables.tg1.z,
            tables.tg2.x, tables.tg2.y, tables.tg2.z,
            tables.tg_sign,
        ],
        ti,
    )

    def col3(k):
        return V3(g[k], g[k + 1], g[k + 2])

    def interp3(k):  # packed vertex attrs at k..k+9 -> V3 interpolated
        return col3(k) * w0 + col3(k + 3) * u + col3(k + 6) * v

    normal = interp3(0)
    if inst_i is not None:
        normal = apply_normal_matrix(tables.inst, inst_i, normal)
    normal = normal.normalized()

    mat_i = jnp.take(tables.tri_mat, ti, axis=0)
    m = tables.materials

    # tangent frame (hit.rchit:61-71): built from the pre-flip normal
    tg_raw = interp3(9)
    if inst_i is not None:
        tg_raw = apply_normal_matrix(tables.inst, inst_i, tg_raw)
    has_tg = tg_raw.any_nonzero()
    sign = g[18]
    tg_n = tg_raw.normalized()

    shading_normal = normal
    uv = None
    tex_idx = None
    if tables.has_textures:
        tex_idx = jnp.take(m.tex_idx, mat_i, axis=0)  # (N, 6)
        uv_g = jnp.take(tables.uv, ti, axis=0)  # (N, 6) [u0 v0 u1 v1 u2 v2]
        uv = jnp.stack(
            [
                w0 * uv_g[:, 0] + u * uv_g[:, 2] + v * uv_g[:, 4],
                w0 * uv_g[:, 1] + u * uv_g[:, 3] + v * uv_g[:, 5],
            ],
            axis=-1,
        )
        # normal mapping (hit.rchit:64-66)
        has_nm = (tex_idx[:, 2] >= 0) & has_tg
        bt0 = normal.cross(tg_n) * sign
        texel = sample_bilinear(tables.tex, tex_idx[:, 2], uv)
        nmap = V3(texel[:, 0] * 2.0 - 1.0, texel[:, 1] * 2.0 - 1.0, texel[:, 2] * 2.0 - 1.0).normalized()
        mapped = (tg_n * nmap.x + bt0 * nmap.y + normal * nmap.z).normalized()
        shading_normal = mapped.where(has_nm, normal)

    # re-orthogonalise tangent against the (possibly mapped) normal
    tg_ortho = (tg_n - shading_normal * shading_normal.dot(tg_n)).normalized()
    bt_ortho = shading_normal.cross(tg_ortho) * sign
    onb_t, onb_b = v3_onb(shading_normal)
    tangent = tg_ortho.where(has_tg, onb_t)
    bitangent = bt_ortho.where(has_tg, onb_b)

    view = -direction
    front = shading_normal.dot(view) >= 0.0
    shading_normal = shading_normal.where(front, -shading_normal)

    # material evaluation (hit.rchit:75-113) — one packed row gather for
    # all 17 per-material scalars when the table is big enough (material
    # tables are usually tiny, where the element path is the known one)
    mg = packed_gather(
        [
            m.base_colour.x, m.base_colour.y, m.base_colour.z,
            m.emissive_v.x, m.emissive_v.y, m.emissive_v.z,
            m.transmission, m.metallic, m.roughness,
            m.aniso_strength, m.aniso_rotation, m.ior,
            m.attenuation.x, m.attenuation.y, m.attenuation.z,
            m.dispersion, m.thin,
        ],
        mat_i,
    )
    base = V3(mg[0], mg[1], mg[2])
    emissive = V3(mg[3], mg[4], mg[5])
    transmission = mg[6]
    metallic = mg[7]
    rough = mg[8]
    aniso_s = mg[9]
    aniso_r = mg[10]

    if tables.has_textures:
        def sample(col):
            return sample_bilinear(tables.tex, tex_idx[:, col], uv)

        has_b = tex_idx[:, 0] >= 0
        tb = sample(0)
        base = (base * V3(tb[:, 0], tb[:, 1], tb[:, 2])).where(has_b, base)
        has_e = tex_idx[:, 3] >= 0
        te = sample(3)
        emissive = (emissive * V3(te[:, 0], te[:, 1], te[:, 2])).where(has_e, emissive)
        has_tr = tex_idx[:, 4] >= 0
        transmission = jnp.where(has_tr, transmission * sample(4)[:, 0], transmission)
        has_mr = tex_idx[:, 1] >= 0
        mr = sample(1)
        metallic = jnp.where(has_mr, metallic * mr[:, 2], metallic)
        rough = jnp.where(has_mr, rough * mr[:, 1], rough)
        has_an = tex_idx[:, 5] >= 0
        an = sample(5)
        aniso_r = jnp.where(has_an, aniso_r + jnp.arctan2(an[:, 1], an[:, 0]), aniso_r)
        aniso_s = jnp.where(has_an, aniso_s * an[:, 2], aniso_s)

    alpha_c = jnp.maximum(rough * rough, 0.001)  # hit.rchit:94-95
    alpha_x = alpha_c + (1.0 - alpha_c) * (aniso_s * aniso_s)  # mix (hit.rchit:112)

    # miss lanes: skybox emission with t = -INF (skybox.rmiss:26-28);
    # under sky=False the caller adds the (deferred) skybox term itself
    if sky:
        skyv = sample_equirect(
            tables.skybox, direction.to_array()) * tables.skybox_strength
        emissive = V3.from_array(skyv).where(miss, emissive)
    else:
        emissive = emissive.where(~miss, V3(0.0, 0.0, 0.0))
    t_out = jnp.where(miss, -INF, t)

    mat = HitMaterial(
        base_colour=base,
        emissive=emissive,
        metallic=metallic,
        alpha_x=alpha_x,
        alpha_y=alpha_c,
        ad_x=jnp.cos(aniso_r),
        ad_y=jnp.sin(aniso_r),
        transmission=transmission,
        ior=mg[11],
        thin=mg[16],
        attenuation=V3(mg[12], mg[13], mg[14]),
        dispersion=mg[15],
    )
    return HitInfo(
        pos=pos,
        normal=shading_normal,
        tangent=tangent,
        bitangent=bitangent,
        t=t_out,
        front_face=front,
        mat=mat,
    )


# ---------------------------------------------------------------------------
# Next-event estimation (shaders/lightsample.glsl)
# ---------------------------------------------------------------------------


def _balance(p1, p2):
    """Balance heuristic (shaders/sampling.glsl:8-10)."""
    return p1 / jnp.maximum(p1 + p2, 1e-30)


def _offset_origin(hit: HitInfo, light_dir: V3) -> V3:
    off = jnp.where(hit.normal.dot(light_dir) >= 0.0, BIAS, -BIAS)
    return hit.pos + hit.normal * off


def _sample_analytic(tables, hit, seed, mask):
    """50/50 point-vs-directional pick (lightsample.glsl:14-52), shadow ray
    deferred: the caller merges it with the emissive branch's into ONE
    traversal launch (the branch picks are random per lane, so separate
    launches each run at half occupancy).

    Returns (radiance V3, light_dir V3, pdf, t_max, seed).
    """
    np_, nd = tables.num_point, tables.num_directional
    p_factor = 1.0 / ((np_ > 0) + (nd > 0))
    n = hit.t.shape[0]

    pick_point = jnp.zeros((n,), bool)
    if np_ > 0:
        u, seed_a = rng.rnd(seed)
        seed = jnp.where(mask, seed_a, seed)  # draw iff numPoint>0 (:17)
        pick_point = (u < 0.5) | (nd == 0)

    idx, seed_i = rng.rnd_int(
        seed,
        jnp.where(pick_point, 0, np_),
        jnp.where(pick_point, max(np_ - 1, 0), np_ + nd - 1),
    )
    seed = jnp.where(mask, seed_i, seed)

    # point branch — one size-gated row gather for the 8 light scalars
    pi = jnp.clip(idx, 0, max(np_ - 1, 0))
    pg = packed_gather(
        [
            tables.pl_pos.x, tables.pl_pos.y, tables.pl_pos.z,
            tables.pl_colour.x, tables.pl_colour.y, tables.pl_colour.z,
            tables.pl_intensity, tables.pl_range,
        ],
        pi,
    )
    l_pos = V3(pg[0], pg[1], pg[2])
    ray = l_pos - hit.pos
    dist = jnp.sqrt(jnp.maximum(ray.length_sq(), 1e-30))
    dir_p = ray / dist
    l_range = pg[7]
    att = jnp.where(
        l_range == 0.0,
        1.0,
        jnp.maximum(1.0 - (dist / jnp.maximum(l_range, 1e-20)) ** 4, 0.0),
    )
    att = jnp.minimum(att / (dist * dist), 1.0)
    rad_p = V3(pg[3], pg[4], pg[5]) * (pg[6] * att)
    pdf_p = jnp.full((n,), p_factor / max(np_, 1), _F32)

    # directional branch — one size-gated row gather
    di = jnp.clip(idx - np_, 0, max(nd - 1, 0))
    dg = packed_gather(
        [
            tables.dl_dir.x, tables.dl_dir.y, tables.dl_dir.z,
            tables.dl_colour.x, tables.dl_colour.y, tables.dl_colour.z,
            tables.dl_intensity,
        ],
        di,
    )
    dir_d = -V3(dg[0], dg[1], dg[2])
    rad_d = V3(dg[3], dg[4], dg[5]) * dg[6]
    pdf_d = jnp.full((n,), p_factor / max(nd, 1), _F32)

    light_dir = dir_p.where(pick_point, dir_d)
    radiance = rad_p.where(pick_point, rad_d)
    pdf = jnp.where(pick_point, pdf_p, pdf_d)
    t_max = jnp.where(pick_point, dist, INF)
    return radiance, light_dir, pdf, t_max, seed


def _sample_emissive(tables, hit, seed, mask):
    """Emissive-triangle NEE sampling (lightsample.glsl:54-141): CDF
    search, uniform point on the triangle, emissive-texture radiance.
    Verification trace and pdf probe are deferred to the caller (merged
    with the analytic branch's shadow into one launch).

    Returns (radiance V3, light_dir V3, t_max, seed).
    """
    u_cdf, seed_c = rng.rnd(seed)
    seed = jnp.where(mask, seed_c, seed)
    tri_e = jnp.clip(
        jnp.searchsorted(tables.em_cdf, u_cdf, side="left"),
        0,
        tables.num_emissive_tris - 1,
    ).astype(jnp.int32)

    (ux, uy), seed_uv = rng.rnd_square(seed)
    seed = jnp.where(mask, seed_uv, seed)
    fold = ux + uy > 1.0  # parallelogram fold (lightsample.glsl:116-119)
    ux = jnp.where(fold, 1.0 - ux, ux)
    uy = jnp.where(fold, 1.0 - uy, uy)

    # emissive-local world-space columns (valid under instancing too,
    # where the global columns hold object-space prototypes); one packed
    # (Te, 9) row gather replaces 9 flat gathers when Te is big enough
    eg = packed_gather(
        [
            tables.em_v0.x, tables.em_v0.y, tables.em_v0.z,
            tables.em_v1.x, tables.em_v1.y, tables.em_v1.z,
            tables.em_v2.x, tables.em_v2.y, tables.em_v2.z,
        ],
        tri_e,
    )
    v0 = V3(eg[0], eg[1], eg[2])
    v1 = V3(eg[3], eg[4], eg[5])
    v2 = V3(eg[6], eg[7], eg[8])
    point = v0 * ux + v1 * uy + v2 * (1.0 - ux - uy)

    ray = point - hit.pos
    dist = jnp.sqrt(jnp.maximum(ray.length_sq(), 1e-30))
    light_dir = ray / dist

    # Verification ray t_max.  The reference traces a closest-hit ray and
    # checks the hit identity (emissive.rchit:47, tMax = dist + EPS,
    # lightsample.glsl:131); "the closest hit is the sampled triangle" is
    # equivalent to "no accepted hit strictly closer than the sampled
    # point", which the terminate-on-first-hit occlusion kernel answers in
    # a fraction of the work (the sampled point lies ON the triangle, so
    # the triangle itself always hits at ~dist).  The epsilon plays the
    # role of the reference's identity check at t-ties.  The trace itself
    # happens in sample_lights, merged with the analytic shadow ray.
    t_max = dist * jnp.float32(1.0 - 1e-4) - jnp.float32(1e-5)

    # emissive radiance folded to emissive-local (Te, 3) columns at trace
    # time (loop-invariant double gather hoisted by XLA) -> one size-gated
    # per-lane gather
    ev = tables.materials.emissive_v
    em_mat = tables.em_mat
    rg = packed_gather(
        [jnp.take(c, em_mat, axis=0) for c in (ev.x, ev.y, ev.z)], tri_e
    )
    radiance = V3(rg[0], rg[1], rg[2])
    if tables.has_textures:
        # emissive.rchit:39-41 modulates by the emissive texture at the
        # verify hit; the hit point IS the sampled point, whose exact
        # barycentric weights are (ux, uy, 1-ux-uy) — no re-intersection
        # needed.  A black texel leaves instanceHit false.
        tex_e = jnp.take(
            jnp.take(tables.materials.tex_idx[:, 3], em_mat, axis=0),
            tri_e, axis=0,
        )
        uv_g = jnp.take(tables.em_uv, tri_e, axis=0)
        w2 = 1.0 - ux - uy
        uv_hit = jnp.stack(
            [
                ux * uv_g[:, 0] + uy * uv_g[:, 2] + w2 * uv_g[:, 4],
                ux * uv_g[:, 1] + uy * uv_g[:, 3] + w2 * uv_g[:, 5],
            ],
            axis=-1,
        )
        te = sample_bilinear(tables.tex, tex_e, uv_hit)
        radiance = (radiance * V3(te[:, 0], te[:, 1], te[:, 2])).where(
            tex_e >= 0, radiance
        )
    return radiance, light_dir, t_max, seed


def sample_lights(tables, hit, wavelength, view_world: V3, seed, mask):
    """Port of sampleLights (lightsample.glsl:143-173).

    Strategy pick between analytic and emissive NEE, BSDF x cos / pdf with
    balance-heuristic MIS for area lights (delta lights exempt).
    Returns (contribution V3, seed, rays_traced).
    """
    has_analytic = tables.num_point + tables.num_directional > 0
    has_emissive = tables.num_emissive_tris > 0
    n = hit.t.shape[0]
    rays = jnp.zeros((), jnp.int32)
    if not has_analytic and not has_emissive:
        return V3.splat((0.0, 0.0, 0.0), (n,)), seed, rays

    if has_analytic:
        u, seed_s = rng.rnd(seed)  # drawn whenever analytic lights exist (:150)
        seed = jnp.where(mask, seed_s, seed)
        pick_analytic = (u < 0.5) | (not has_emissive)
    else:
        pick_analytic = jnp.zeros((n,), bool)

    radiance = V3.splat((0.0, 0.0, 0.0), (n,))
    light_dir = V3.splat((0.0, 0.0, 0.0), (n,))
    pdf = jnp.zeros((n,), _F32)
    t_max = jnp.full((n,), INF, _F32)
    delta = pick_analytic

    if has_analytic:
        rad_a, dir_a, pdf_a, tmax_a, seed = _sample_analytic(
            tables, hit, seed, mask & pick_analytic
        )
        radiance = rad_a.where(pick_analytic, radiance)
        light_dir = dir_a.where(pick_analytic, light_dir)
        pdf = jnp.where(pick_analytic, pdf_a, pdf)
        t_max = jnp.where(pick_analytic, tmax_a, t_max)
        rays = rays + jnp.sum(mask & pick_analytic, dtype=jnp.int32)
    if has_emissive:
        rad_e, dir_e, tmax_e, seed = _sample_emissive(
            tables, hit, seed, mask & ~pick_analytic
        )
        radiance = radiance.where(pick_analytic, rad_e)
        light_dir = light_dir.where(pick_analytic, dir_e)
        t_max = jnp.where(pick_analytic, t_max, tmax_e)
        rays = rays + jnp.sum(mask & ~pick_analytic, dtype=jnp.int32)

    # NdotL / black-light pruning: a lane whose NEE contribution is zero
    # regardless of occlusion — sampled radiance == 0, or BSDF == 0 toward
    # the light (e.g. an opaque lane whose sampled light sits below its
    # horizon) — need not trace at all.  The BSDF is occlusion-independent,
    # so evaluating it BEFORE the launch is free reordering; pruned lanes
    # go dead and their walk ends at once.  The reference traces every shadow
    # ray unconditionally (lightsample.glsl:45,:131 — bsdf is applied
    # after), so the ray counters above keep its accounting and the
    # Mrays/s denominator is unchanged.  Alpha scenes skip the prune:
    # their shadow traversal consumes per-lane RNG (stochastic BLEND), and
    # pruning would desync the streams vs the scalar oracle.
    tview = v3_to_tangent(view_world, hit.tangent, hit.bitangent, hit.normal)
    tlight = v3_to_tangent(light_dir, hit.tangent, hit.bitangent, hit.normal)
    bsdf_val = material_bsdf(hit, wavelength, tview, tlight)
    trace_mask = mask
    if not tables.has_alpha and not os.environ.get("VKRT_NO_NEE_PRUNE"):
        trace_mask = mask & radiance.any_nonzero() & bsdf_val.any_nonzero()

    # ONE merged occlusion launch for both branches (the analytic shadow
    # ray, lightsample.glsl:45, and the emissive verification ray, :131):
    # branch picks are random per lane, so two masked launches would each
    # run at half occupancy for twice the fixed cost.
    ray_o = _offset_origin(hit, light_dir)
    occluded, seed = _shadow(
        tables, ray_o, light_dir, t_max=t_max, active=trace_mask, seed=seed
    )
    radiance = radiance.where(~occluded & trace_mask, V3(0.0, 0.0, 0.0))
    if has_emissive:
        # pdf probe over all emissive surfaces along the verified ray
        # (lightsample.glsl:136); only surviving emissive-branch lanes
        visible = mask & ~pick_analytic & ~occluded & radiance.any_nonzero()
        pdf_e = _emissive_pdf(tables, ray_o, light_dir, t_min=0.0, active=visible)
        pdf = jnp.where(pick_analytic, pdf, pdf_e)
        radiance = radiance.where(pick_analytic | visible, V3(0.0, 0.0, 0.0))
        rays = rays + jnp.sum(visible, dtype=jnp.int32)

    got_light = radiance.any_nonzero() & mask
    pdf = pdf / _F32(max(1, int(has_analytic) + int(has_emissive)))  # :161
    mis = jnp.where(delta, 1.0, _balance(pdf, material_pdf(hit, tview, tlight)))
    scale = mis * jnp.abs(hit.normal.dot(light_dir)) / jnp.maximum(pdf, 1e-30)
    contrib = (radiance * bsdf_val * scale).where(
        got_light & bsdf_val.any_nonzero(), V3(0.0, 0.0, 0.0)
    )
    return contrib, seed, rays


# ---------------------------------------------------------------------------
# The bounce loop (raygen.rgen:52-88)
# ---------------------------------------------------------------------------


def render_sample(
    tables, view_inv, proj_inv, width, height, sample_count, max_depth,
    lane_idx=None, nee_weighting="reference",
):
    """Path-trace one sample for every pixel (or the given pixel lanes).

    Returns (radiance (N, 3), rays_traced ()) with N = width*height (or
    len(lane_idx)); the ray counter tallies every traversal launched on an
    active lane (material + shadow/verify + pdf probes) for the Mrays/s
    benchmark metric.

    ``nee_weighting``: "reference" replicates raygen.rgen:54-83 exactly —
    the NEE contribution at a hit is scaled by the path throughput
    *including* that hit's own BSDF sample estimator (an energy quirk of the
    reference; direct lighting is attenuated by an unrelated lobe sample).
    "physical" weights NEE by the throughput up to the hit only — the
    mathematically standard estimator (brighter, unbiased direct light).
    """
    # opt-in coherence repacking: group lanes into 32x32 pixel blocks and
    # re-sort the wavefront between bounces; s["slot"] carries each lane's
    # output position
    repack = _repack()
    # deferred post-loop skybox fetch (VKRT_NO_DEFERRED_SKY=1 fetches per
    # bounce instead)
    defer_sky = not os.environ.get("VKRT_NO_DEFERRED_SKY")
    slot = None
    if lane_idx is None and repack:
        order, _ = _block_order(width, height)
        lane_idx = jnp.asarray(order)
        slot = lane_idx.astype(jnp.int32)

    origin, direction, seed = generate_primary_rays(
        view_inv, proj_inv, width, height, sample_count, lane_idx
    )
    n = seed.shape[0]
    preview = jnp.uint32(sample_count) == jnp.uint32(0)
    if slot is None:
        slot = jnp.arange(n, dtype=jnp.int32)

    state = dict(
        origin=origin,
        direction=direction,
        value=V3.splat((0.0, 0.0, 0.0), (n,)),
        throughput=V3.splat((1.0, 1.0, 1.0), (n,)),
        seed=seed,
        wavelength=jnp.zeros((n,), _F32),
        mat_pdf=jnp.ones((n,), _F32),
        active=jnp.ones((n,), bool),
        slot=slot,
        sky_w=V3.splat((0.0, 0.0, 0.0), (n,)),
        # per-lane under sample batching (each lane is a (pixel, sample)
        # pair); lives in the state so the width ladder slices it
        preview=jnp.broadcast_to(preview, (n,)),
        rays=jnp.zeros((), jnp.int32),
    )

    def bounce(b, s):
        active = s["active"]
        n_active = jnp.sum(active, dtype=jnp.int32)

        (t, tri, u, v), seed = _closest(
            tables,
            s["origin"],
            s["direction"],
            t_min=EPS,
            t_max=INF,
            active=active,
            seed=s["seed"],
        )
        hit = eval_hit(tables, s["origin"], s["direction"], t, tri, u, v,
                       sky=not defer_sky)

        miss = tri < 0
        is_emissive = hit.mat.emissive.any_nonzero()
        terminal = (
            miss | is_emissive | (b == max_depth) | (s["preview"] & (b == 1))
        )

        # deferred skybox (skybox.rmiss): record throughput at the miss —
        # the lane goes inactive here and its direction survives in the
        # final state, so ONE post-loop equirect fetch serves every bounce
        sky_w = s["sky_w"]
        if defer_sky:
            sky_w = sky_w + s["throughput"].where(
                active & miss, V3(0.0, 0.0, 0.0))

        # emissive MIS probe (raygen.rgen:67-73); miss lanes keep weight 1
        probe_mask = active & terminal & is_emissive & ~miss & (b != 0)
        pdf_probe = _emissive_pdf(
            tables, s["origin"], s["direction"], t_min=EPS, active=probe_mask
        )
        weight = jnp.where(probe_mask, _balance(s["mat_pdf"], pdf_probe), 1.0)
        add = (s["throughput"] * hit.mat.emissive * weight).where(
            active & terminal, V3(0.0, 0.0, 0.0)
        )
        value = s["value"] + add

        cont = active & ~terminal

        # material sample at this hit (raygen.rgen:79-83)
        view = -s["direction"]
        tview = v3_to_tangent(view, hit.tangent, hit.bitangent, hit.normal)
        d_t, est, pdf_m, _, wl_new, seed_m = sample_material(
            seed, hit, s["wavelength"], tview
        )
        seed = jnp.where(cont, seed_m, seed)
        wavelength = jnp.where(cont, wl_new, s["wavelength"])
        new_dir = v3_from_tangent(d_t, hit.tangent, hit.bitangent, hit.normal)
        throughput = (s["throughput"] * est).where(cont, s["throughput"])
        mat_pdf = jnp.where(cont, pdf_m, s["mat_pdf"])
        alive = cont & throughput.any_nonzero()  # raygen.rgen:84

        off = jnp.where(hit.normal.dot(new_dir) >= 0.0, BIAS, -BIAS)
        new_origin = hit.pos + hit.normal * off
        origin = new_origin.where(cont, s["origin"])
        direction = new_dir.where(cont, s["direction"])

        # NEE for surviving lanes (raygen.rgen:54-56 semantics: throughput
        # already includes this hit's estimator; runs before the next trace)
        light, seed, nee_rays = sample_lights(
            tables, hit, wavelength, view, seed, alive
        )
        nee_throughput = throughput if nee_weighting == "reference" else s["throughput"]
        value = value + (nee_throughput * light).where(alive, V3(0.0, 0.0, 0.0))

        # ray accounting: material rays + NEE rays + terminal emissive probes
        rays = s["rays"] + n_active + jnp.sum(probe_mask, dtype=jnp.int32) + nee_rays

        return dict(
            origin=origin,
            direction=direction,
            value=value,
            throughput=throughput,
            seed=seed,
            wavelength=wavelength,
            mat_pdf=mat_pdf,
            active=alive,
            slot=s["slot"],
            sky_w=sky_w,
            preview=s["preview"],
            rays=rays,
        )

    # while-loop with early exit: once every lane terminated (miss/emissive/
    # zero throughput) remaining bounces are skipped — the wavefront analogue
    # of the reference's per-thread `break` (raygen.rgen:64,84)
    def run_phase(b0, s0, live_floor):
        """Bounce at this state's width while more than ``live_floor``
        lanes are alive (and bounces remain)."""

        def cond(carry):
            b, s = carry
            alive = jnp.sum(s["active"], dtype=jnp.int32)
            return (b <= max_depth) & (alive > live_floor)

        def body(carry):
            b, s = carry
            if repack:  # static: re-sort bounce wavefronts for coherence
                s = jax.lax.cond(
                    b > 0, lambda st: _sort_wavefront(tables, st),
                    lambda st: st, s,
                )
            return b + 1, bounce(b, s)

        return jax.lax.while_loop(cond, body, (b0, s0))

    if repack and n % 4 == 0 and not os.environ.get("VKRT_NO_WIDTH_LADDER"):
        # Wavefront width ladder: the eval half of a bounce
        # (eval_hit/sample_material/sample_lights) runs at FULL band width
        # however many lanes are dead.  The coherence sort is dead-last,
        # so once at most half the lanes are alive the live wavefront is
        # a PREFIX: sort, statically slice it, and keep bouncing at
        # half (then quarter) width — the wavefront-compaction analogue
        # the reference gets from its hardware scheduler's thread
        # retirement (raygen.rgen:64,84 early breaks).  Dead lanes'
        # state is invariant under bounce(), so the sliced-out tail
        # needs no further work; results are bit-identical.
        b1, s1 = run_phase(jnp.int32(0), state, jnp.int32(n // 2))

        def boundary(s, m):
            """Sort live-first (full current width), split prefix."""
            s = jax.lax.cond(
                jnp.any(s["active"]),
                lambda st: _sort_wavefront(tables, st), lambda st: st, s,
            )
            lo, hi = {}, {}
            for k, v in s.items():
                if isinstance(v, V3):
                    lo[k] = V3(v.x[:m], v.y[:m], v.z[:m])
                    hi[k] = V3(v.x[m:], v.y[m:], v.z[m:])
                elif k == "rays":
                    lo[k] = v
                    hi[k] = None
                else:
                    lo[k], hi[k] = v[:m], v[m:]
            return lo, hi

        def rejoin(lo, hi):
            out = {}
            for k, v in lo.items():
                if isinstance(v, V3):
                    out[k] = V3(
                        jnp.concatenate([v.x, hi[k].x]),
                        jnp.concatenate([v.y, hi[k].y]),
                        jnp.concatenate([v.z, hi[k].z]),
                    )
                elif k == "rays":
                    out[k] = v
                else:
                    out[k] = jnp.concatenate([v, hi[k]])
            return out

        half, tail_h = boundary(s1, n // 2)
        b2, half = run_phase(b1, half, jnp.int32(n // 4))
        quart, tail_q = boundary(half, n // 4)
        _, quart = run_phase(b2, quart, jnp.int32(0))
        out = rejoin(rejoin(quart, tail_q), tail_h)
    else:
        _, out = run_phase(jnp.int32(0), state, jnp.int32(0))
    value = out["value"]
    if defer_sky:
        # deferred skybox: one equirect fetch for the whole loop (each lane
        # misses at most once; its miss direction survived in the state)
        sky = sample_equirect(
            tables.skybox, out["direction"].to_array()
        ) * tables.skybox_strength
        value = value + out["sky_w"] * V3.from_array(sky)
    value = value.to_array()
    if repack:  # lanes were permuted; scatter back to output positions
        value = jnp.zeros_like(value).at[out["slot"]].set(value)
    return value, out["rays"]
