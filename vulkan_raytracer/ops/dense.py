"""Dense (gather-free) ray/triangle intersection for small scenes.

Test EVERY ray against EVERY triangle — pure element-wise work XLA fuses
into tiled loops — folding a running closest-hit over triangle chunks.  For
the reference's default workloads (CornellBox et al.) this plays the role
of the hardware RT core; larger scenes take the per-ray BVH walk
(:mod:`vulkan_raytracer.ops.bvh_kernel`).

Layout notes:
* vectors are *component arrays*, never ``(..., 3)``;
* the test matrix is **triangles-major** ``(T_chunk, N_rays)`` and the
  closest-hit reduce runs over the triangle axis;
* the winning triangle's barycentrics are recomputed once per ray from 9
  flat 1-D gathers instead of being carried through the fold.

Semantics identical to the traversal module: closest hit, any-hit occlusion
(shadow), and the emissive-pdf probe (shaders/emissivepdf.rahit).  The
deterministic alpha MASK test is supported (reject triangles whose material
alpha is below the cutoff, hit.rahit:52); stochastic BLEND requires
per-intersection RNG ordering and routes through the BVH path instead.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .math3 import v3_gather

#: Scenes at or below this many triangles use dense intersection; above it
#: they take the per-ray BVH walk.  On the H100 the BVH kernel beat the
#: dense fold at every size measured, down to the 36-triangle Cornell box
#: (per launch and end to end, PERF.md, PR 1), so by default every scene
#: takes the walk.  VKRT_DENSE_MAX overrides.
DENSE_MAX_TRIS = int(os.environ.get("VKRT_DENSE_MAX", 0))

#: Triangle rows per fold step (multiple of the 8-sublane tile height).
CHUNK = 64

_BIG = jnp.float32(3e38)


def _pad_to(x, t_pad):
    pad = t_pad - x.shape[0]
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x


def _tri_rows(tables, mask_alpha):
    """Per-triangle MT constants as padded (T_pad, 1) component columns."""
    t_count = tables.v0.x.shape[0]
    nc = max(1, -(-t_count // CHUNK))
    t_pad = nc * CHUNK
    v0, v1, v2 = tables.v0, tables.v1, tables.v2
    comps = tuple(
        _pad_to(c, t_pad)[:, None]
        for c in (
            v0.x, v0.y, v0.z,
            v1.x - v0.x, v1.y - v0.y, v1.z - v0.z,
            v2.x - v0.x, v2.y - v0.y, v2.z - v0.z,
        )
    )
    valid = jnp.arange(t_pad) < t_count
    if mask_alpha and tables.has_alpha:
        amode = _pad_to(tables.alpha.mode, t_pad)
        aval = _pad_to(tables.alpha.value, t_pad)
        acut = _pad_to(tables.alpha.cutoff, t_pad)
        valid = valid & ~((amode == 1) & (aval < acut))
    return comps, valid[:, None], nc, t_count


def _slice_rows(tri, valid, s):
    rows = tuple(jax.lax.dynamic_slice_in_dim(c, s, CHUNK, axis=0) for c in tri)
    return rows, jax.lax.dynamic_slice_in_dim(valid, s, CHUNK, axis=0)


def _mt_chunk(o, d, rows, vmask, t_min, t_max_row):
    """Möller-Trumbore on (CHUNK, N) component tensors.

    o/d: tuples of (N,)-shaped ray components (broadcast as (1, N) rows);
    rows: (CHUNK, 1) triangle component columns.  Returns (hit, t, u, v).
    """
    ox, oy, oz, dx, dy, dz = (c[None, :] for c in o + d)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows

    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    near_zero = jnp.abs(det) < 1e-12
    inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
    # tvec = o - v0
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        vmask
        & ~near_zero
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t <= t_max_row)
    )
    return hit, t, u, v


def _ray_comps(o, d):
    return (o.x, o.y, o.z), (d.x, d.y, d.z)


def dense_closest(tables, o, d, *, t_min, t_max, active, mask_alpha=True):
    """Closest hit over all triangles; mirrors trace_closest's returns
    (t, tri, u, v) with t=+inf / tri=-1 on miss."""
    n = o.x.shape[0]
    tri, valid, nc, t_count = _tri_rows(tables, mask_alpha)
    oc, dc = _ray_comps(o, d)
    t_bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    row = jnp.arange(CHUNK, dtype=jnp.int32)[:, None]

    def fold(c, carry):
        t_best, tri_best = carry
        s = c * CHUNK
        rows, vmask = _slice_rows(tri, valid, s)
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

    init = (jnp.where(active, t_bound, 0.0), jnp.full((n,), -1, jnp.int32))
    if nc == 1:
        t_best, tri_best = fold(0, init)
    else:
        t_best, tri_best = jax.lax.fori_loop(0, nc, fold, init)

    found = (tri_best >= 0) & (tri_best < t_count)
    tri_best = jnp.where(found, tri_best, -1)

    # recompute (u, v) for the single winning triangle (9 flat gathers/lane)
    ti = jnp.maximum(tri_best, 0)
    wv0 = v3_gather(tables.v0, ti)
    wv1 = v3_gather(tables.v1, ti)
    wv2 = v3_gather(tables.v2, ti)
    e1 = wv1 - wv0
    e2 = wv2 - wv0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tvec = o - wv0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det

    return (
        jnp.where(found, t_best, jnp.inf),
        tri_best,
        jnp.where(found, u, 0.0),
        jnp.where(found, v, 0.0),
    )


def dense_shadow(tables, o, d, *, t_max, active):
    """Any-hit occlusion over all triangles (tMin = 0, lightsample.glsl:27)."""
    n = o.x.shape[0]
    tri, valid, nc, _ = _tri_rows(tables, mask_alpha=True)
    oc, dc = _ray_comps(o, d)
    t_bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    def fold(c, occ):
        rows, vmask = _slice_rows(tri, valid, c * CHUNK)
        hit, _, _, _ = _mt_chunk(oc, dc, rows, vmask, 0.0, t_bound[None, :])
        return occ | jnp.any(hit, axis=0)

    init = jnp.zeros((n,), bool)
    occ = fold(0, init) if nc == 1 else jax.lax.fori_loop(0, nc, fold, init)
    return occ & active


def dense_emissive_pdf(tables, o, d, *, t_min, active):
    """Sum the NEE pdf over every emissive triangle along each ray
    (shaders/emissivepdf.rahit:57-67).  Emissive sets are small (they feed
    the sampling CDF); the cosine uses the interpolated vertex normal
    flipped toward the ray origin."""
    em = tables.em_tables
    te = tables.em_tri.shape[0]
    nc = max(1, -(-te // CHUNK))
    t_pad = nc * CHUNK
    ev0, ev1, ev2 = tables.em_v0, tables.em_v1, tables.em_v2
    tri = tuple(
        _pad_to(c, t_pad)[:, None]
        for c in (
            ev0.x, ev0.y, ev0.z,
            ev1.x - ev0.x, ev1.y - ev0.y, ev1.z - ev0.z,
            ev2.x - ev0.x, ev2.y - ev0.y, ev2.z - ev0.z,
        )
    )
    valid = (jnp.arange(t_pad) < te)[:, None]
    n0 = tuple(_pad_to(em.n0[:, k], t_pad)[:, None] for k in range(3))
    n1 = tuple(_pad_to(em.n1[:, k], t_pad)[:, None] for k in range(3))
    n2 = tuple(_pad_to(em.n2[:, k], t_pad)[:, None] for k in range(3))
    p_delta = _pad_to(em.p_delta, t_pad)[:, None]
    area = _pad_to(jnp.maximum(em.area, 1e-30), t_pad)[:, None]
    oc, dc = _ray_comps(o, d)

    def fold(c, pdf):
        s = c * CHUNK
        rows, vmask = _slice_rows(tri, valid, s)
        hit, t, u, v = _mt_chunk(oc, dc, rows, vmask, t_min, _BIG)
        hit = hit & active[None, :]
        w0 = 1.0 - u - v
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, s, CHUNK, axis=0)
        nx = w0 * sl(n0[0]) + u * sl(n1[0]) + v * sl(n2[0])
        ny = w0 * sl(n0[1]) + u * sl(n1[1]) + v * sl(n2[1])
        nz = w0 * sl(n0[2]) + u * sl(n1[2]) + v * sl(n2[2])
        inv_len = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-30))
        cosine = jnp.abs(
            nx * dc[0][None, :] + ny * dc[1][None, :] + nz * dc[2][None, :]
        ) * inv_len
        contrib = sl(p_delta) * t * t / jnp.maximum(sl(area) * cosine, 1e-30)
        return pdf + jnp.sum(jnp.where(hit, contrib, 0.0), axis=0)

    init = jnp.zeros((o.x.shape[0],), jnp.float32)
    return fold(0, init) if nc == 1 else jax.lax.fori_loop(0, nc, fold, init)
