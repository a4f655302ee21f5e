"""Two-level (TLAS/BLAS) traversal for instanced scenes.

The reference shares one BLAS across many TLAS instances with per-instance
3x4 transforms (accelerationstructure.cpp:157-177); flattening every
instance to world space (the round-1/2 design, scenegraph.py) costs
O(instances x triangles) memory — a scene composing 100 copies of a 262k
triangle model would build a 26M-triangle soup.  This module keeps shared
geometry once and traverses it per instance:

* **prototype columns** — `SceneTables.v0/...` hold each unique primitive's
  triangles ONCE, in *object space*;
* **instance tables** (:class:`InstanceTables`) — per-instance world->object
  affine transforms, inverse-transpose rotations for normals, and world
  AABBs, grouped by prototype;
* **traversal** — a `lax.scan` over each prototype's instances: the world
  rays transform into the instance's object space (an affine map preserves
  the ray parameter t when the direction transforms linearly, so world and
  object t agree and the running closest-hit bound tightens across
  instances), then intersect the prototype with the dense triangles-major
  fold (<= DENSE_MAX_TRIS) or the per-ray BVH walk (beyond,
  :mod:`.bvh_kernel`).  The per-instance world-AABB slab test plays the
  TLAS role — a flat sweep over instances.

Hit identity is the encoded id ``instance * num_proto_tris + proto_tri``
(the analogue of ``gl_InstanceCustomIndexEXT`` + ``gl_PrimitiveID``,
hit.rchit:33); the integrator decodes it to fetch prototype attributes and
the instance's normal matrix (render/integrator.py:eval_hit).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .dense import CHUNK, _BIG, _mt_chunk, _pad_to, _slice_rows
from .intersect import ray_aabb, safe_inv_dir
from .math3 import V3, v3_gather
from .bvh_kernel import bvh_closest, bvh_shadow


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InstanceGroup:
    """All instances of one prototype (a unique glTF primitive)."""

    inv: jax.Array  # (Ip, 12) row-major 3x4 world->object transforms
    aabb_min: jax.Array  # (Ip, 3) world-space instance bounds
    aabb_max: jax.Array  # (Ip, 3)
    inst_id: jax.Array  # (Ip,) i32 global instance index
    #: ThreadedBVH over the prototype's OBJECT-space triangles when
    #: tri_cnt > DENSE_MAX_TRIS, else None (dense fold path)
    blas: object
    tri_off: int = dataclasses.field(metadata=dict(static=True))
    tri_cnt: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InstanceTables:
    """Scene-level instancing state carried inside :class:`SceneTables`."""

    groups: tuple  # tuple[InstanceGroup, ...] in prototype order
    inv_flat: jax.Array  # (12, I) world->object rows (gatherable columns)
    nrm_flat: jax.Array  # (9, I) inverse-transpose rotation rows
    num_instances: int = dataclasses.field(metadata=dict(static=True))
    num_proto_tris: int = dataclasses.field(metadata=dict(static=True))

    def decode(self, enc):
        """Encoded hit id -> (prototype triangle, instance)."""
        p = jnp.int32(self.num_proto_tris)
        return enc % p, enc // p


def apply_normal_matrix(inst: InstanceTables, ii, v: V3) -> V3:
    """Object-space normal/tangent -> world via the instance's
    inverse-transpose rotation (hit.rchit:59-60); 9 flat 1-D gathers."""
    m = tuple(jnp.take(inst.nrm_flat[k], ii, axis=0) for k in range(9))
    return V3(
        m[0] * v.x + m[1] * v.y + m[2] * v.z,
        m[3] * v.x + m[4] * v.y + m[5] * v.z,
        m[6] * v.x + m[7] * v.y + m[8] * v.z,
    )


def _apply_affine(m, p: V3) -> V3:
    """3x4 row-major affine transform of points; m is (12,) or (12, N)."""
    return V3(
        m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
        m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
        m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11],
    )


def _apply_linear(m, v: V3) -> V3:
    """Rotation/scale part only (directions; t stays in world units)."""
    return V3(
        m[0] * v.x + m[1] * v.y + m[2] * v.z,
        m[4] * v.x + m[5] * v.y + m[6] * v.z,
        m[8] * v.x + m[9] * v.y + m[10] * v.z,
    )


def _range_columns(tables, off: int, cnt: int):
    """Prototype triangle slice as padded (T_pad, 1) MT component columns.

    Mirrors dense._tri_rows incl. the deterministic MASK-alpha prefilter
    (always-transparent triangles never hit, hit.rahit:52)."""
    nc = max(1, -(-cnt // CHUNK))
    t_pad = nc * CHUNK
    v0, v1, v2 = tables.v0, tables.v1, tables.v2

    def col(c):
        return _pad_to(c[off : off + cnt], t_pad)[:, None]

    comps = tuple(
        col(c)
        for c in (
            v0.x, v0.y, v0.z,
            v1.x - v0.x, v1.y - v0.y, v1.z - v0.z,
            v2.x - v0.x, v2.y - v0.y, v2.z - v0.z,
        )
    )
    valid = jnp.arange(t_pad) < cnt
    if tables.has_alpha:
        amode = _pad_to(tables.alpha.mode[off : off + cnt], t_pad)
        aval = _pad_to(tables.alpha.value[off : off + cnt], t_pad)
        acut = _pad_to(tables.alpha.cutoff[off : off + cnt], t_pad)
        valid = valid & ~((amode == 1) & (aval < acut))
    return comps, valid[:, None], nc


def _fold_closest(comps, valid, nc, o2: V3, d2: V3, t_min, t_init, tri_init):
    """Running closest-hit fold over one prototype (dense.py fold body)."""
    oc = (o2.x, o2.y, o2.z)
    dc = (d2.x, d2.y, d2.z)
    row = jnp.arange(CHUNK, dtype=jnp.int32)[:, None]

    def fold(c, carry):
        t_best, tri_best = carry
        s = c * CHUNK
        rows, vmask = _slice_rows(comps, valid, s)
        hit, t, _, _ = _mt_chunk(oc, dc, rows, vmask, t_min, t_best[None, :])
        t = jnp.where(hit, t, _BIG)
        t_chunk = jnp.min(t, axis=0)
        idx_chunk = jnp.min(
            jnp.where(hit & (t <= t_chunk[None, :]), s + row, jnp.int32(2**30)),
            axis=0,
        )
        closer = t_chunk < t_best
        return (
            jnp.where(closer, t_chunk, t_best),
            jnp.where(closer, idx_chunk, tri_best),
        )

    init = (t_init, tri_init)
    return fold(0, init) if nc == 1 else jax.lax.fori_loop(0, nc, fold, init)


def instanced_closest(tables, o: V3, d: V3, *, t_min, t_max, active):
    """Closest hit over every instance; returns (t, enc_tri, u, v).

    ``enc_tri`` is the encoded (instance, prototype-triangle) id; -1 on
    miss.  ``t_min``/``t_max`` may be per-lane (the alpha resample loop).
    """
    inst: InstanceTables = tables.inst
    n = o.x.shape[0]
    p_total = inst.num_proto_tris
    t_bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    o_arr = o.to_array()
    inv_d = safe_inv_dir(d.to_array())

    # inactive lanes carry t_best = 0: no instance AABB and no triangle can
    # ever pass its interval test (the dense-fold init trick, dense.py:155)
    t_best = jnp.where(active, t_bound, 0.0)
    enc = jnp.full((n,), -1, jnp.int32)

    for g in inst.groups:  # static: one scan per prototype
        if g.blas is None:
            cols, valid, nc = _range_columns(tables, g.tri_off, g.tri_cnt)

        def step(carry, xs, g=g):
            t_c, enc_c = carry
            m, bmin, bmax, iid = xs
            touches = ray_aabb(o_arr, inv_d, bmin, bmax, jnp.float32(0.0), t_c)

            def walk(c):
                t_c, enc_c = c
                o2 = _apply_affine(m, o)
                d2 = _apply_linear(m, d)
                if g.blas is None:
                    t_n, lt = _fold_closest(
                        cols, valid, nc, o2, d2, t_min,
                        jnp.where(touches, t_c, 0.0), jnp.full((n,), -1, jnp.int32),
                    )
                    hit_new = (lt >= 0) & (lt < g.tri_cnt)
                else:
                    # per-ray walk in object space; the running world-t
                    # bound carries over (affine maps preserve the ray
                    # parameter)
                    t_n, lt, _, _ = bvh_closest(
                        g.blas, o2, d2, t_min=t_min, t_max=t_c,
                        active=touches,
                    )
                    hit_new = lt >= 0
                closer = hit_new & (t_n < t_c)
                enc_new = iid * jnp.int32(p_total) + jnp.int32(g.tri_off) + lt
                return (
                    jnp.where(closer, t_n, t_c),
                    jnp.where(closer, enc_new, enc_c),
                )

            carry = jax.lax.cond(jnp.any(touches), walk, lambda c: c, (t_c, enc_c))
            return carry, None

        (t_best, enc), _ = jax.lax.scan(
            step, (t_best, enc), (g.inv, g.aabb_min, g.aabb_max, g.inst_id)
        )

    found = enc >= 0
    # recompute (u, v) once for the winning (instance, triangle): transform
    # the ray into the winner's object space (12 gathers) and evaluate MT
    # against the prototype verts (9 gathers) — same shape as dense.py:164
    pti, ii = inst.decode(jnp.maximum(enc, 0))
    ii = jnp.minimum(ii, inst.num_instances - 1)
    m = tuple(jnp.take(inst.inv_flat[k], ii, axis=0) for k in range(12))
    o2 = _apply_affine(m, o)
    d2 = _apply_linear(m, d)
    wv0 = v3_gather(tables.v0, pti)
    wv1 = v3_gather(tables.v1, pti)
    wv2 = v3_gather(tables.v2, pti)
    e1 = wv1 - wv0
    e2 = wv2 - wv0
    pvec = d2.cross(e2)
    det = e1.dot(pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tvec = o2 - wv0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d2.dot(qvec) * inv_det

    return (
        jnp.where(found, t_best, jnp.inf),
        jnp.where(found, enc, -1),
        jnp.where(found, u, 0.0),
        jnp.where(found, v, 0.0),
    )


def instanced_shadow(tables, o: V3, d: V3, *, t_max, active):
    """Any-hit occlusion over every instance (tMin = 0)."""
    inst: InstanceTables = tables.inst
    n = o.x.shape[0]
    t_bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    o_arr = o.to_array()
    inv_d = safe_inv_dir(d.to_array())
    occ = jnp.zeros((n,), bool)

    for g in inst.groups:
        if g.blas is None:
            cols, valid, nc = _range_columns(tables, g.tri_off, g.tri_cnt)

        def step(occ_c, xs, g=g):
            m, bmin, bmax, _iid = xs
            live = active & ~occ_c
            touches = live & ray_aabb(
                o_arr, inv_d, bmin, bmax, jnp.float32(0.0), t_bound
            )

            def walk(occ_c):
                o2 = _apply_affine(m, o)
                d2 = _apply_linear(m, d)
                if g.blas is None:
                    t_lim = jnp.where(touches, t_bound, 0.0)

                    def fold(c, hitacc):
                        rows, vmask = _slice_rows(cols, valid, c * CHUNK)
                        hit, _, _, _ = _mt_chunk(
                            (o2.x, o2.y, o2.z), (d2.x, d2.y, d2.z),
                            rows, vmask, 0.0, t_lim[None, :],
                        )
                        return hitacc | jnp.any(hit, axis=0)

                    z = jnp.zeros((n,), bool)
                    hit = fold(0, z) if nc == 1 else jax.lax.fori_loop(0, nc, fold, z)
                else:
                    hit = bvh_shadow(
                        g.blas, o2, d2, t_max=t_bound, active=touches,
                    )
                return occ_c | (hit & touches)

            occ_c = jax.lax.cond(jnp.any(touches), walk, lambda c: c, occ_c)
            return occ_c, None

        occ, _ = jax.lax.scan(step, occ, (g.inv, g.aabb_min, g.aabb_max, g.inst_id))

    return occ & active
