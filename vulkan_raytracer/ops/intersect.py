"""Ray/triangle and ray/AABB primitives.

These replace the GPU RT-core intersection hardware the reference drives via
``traceRayEXT`` (shaders/raygen.rgen:59).  Everything is branch-free,
vectorised over arbitrary leading batch dims, and NaN-safe so it can run
under masked lanes inside ``lax.while_loop``.
"""

from __future__ import annotations

import jax.numpy as jnp

from .math3 import cross3, dot3

#: Intersections closer than this are rejected (mirrors the reference's ray
#: tMin of EPS=1e-7 for material rays, shaders/raygen.rgen:59).
DEFAULT_T_MIN = 1e-7


def safe_inv_dir(d):
    """1/d with zero components replaced by a signed tiny value.

    Keeps the slab test free of 0*inf NaNs while preserving the sign of the
    direction for correct interval ordering.
    """
    tiny = 1e-20
    d_safe = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    return 1.0 / d_safe


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test: does [t_min, t_max] overlap the box interval?

    Shapes broadcast; returns a boolean mask.
    """
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    tnear = jnp.max(tlo, axis=-1)
    tfar = jnp.min(thi, axis=-1)
    return (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_max)


def ray_triangle(o, d, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore intersection.

    Args:
      o, d: ray origin/direction, shape (..., 3).  ``d`` need not be unit —
        the reference traces non-normalised BSDF sample directions
        (shaders/random.glsl:87-94 returns non-unit vectors) and ``t`` is in
        units of ``|d|``; we preserve those semantics.
      v0, e1, e2: triangle origin vertex and edge vectors ``v1-v0``, ``v2-v0``.
      t_min, t_max: accepted parametric range (broadcastable).

    Returns:
      (hit, t, u, v): boolean mask and barycentrics with the glTF/Vulkan
      convention — the hit attribute is (u, v) with weights
      (1-u-v, u, v) for (v0, v1, v2) (shaders/hit.rchit:117).
    """
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    # Two-sided test (the reference builds no cull flags; both faces hit).
    near_zero = jnp.abs(det) < 1e-12
    inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = (
        (~near_zero)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t <= t_max)
    )
    return hit, jnp.where(hit, t, jnp.inf), u, v


def brute_force_closest(o, d, v0, e1, e2, t_min, t_max):
    """Closest hit against ALL triangles — O(N_rays x N_tris), no BVH.

    The degenerate path for tiny scenes and the oracle for BVH correctness
    tests.  o/d: (R, 3); v0/e1/e2: (T, 3).
    Returns (t, tri_idx, u, v) with tri_idx == -1 on miss.
    """
    hit, t, u, v = ray_triangle(
        o[:, None, :],
        d[:, None, :],
        v0[None, :, :],
        e1[None, :, :],
        e2[None, :, :],
        jnp.asarray(t_min)[..., None],
        jnp.asarray(t_max)[..., None],
    )
    best = jnp.argmin(t, axis=1)
    r = jnp.arange(t.shape[0])
    t_best = t[r, best]
    found = jnp.isfinite(t_best)
    return (
        jnp.where(found, t_best, jnp.inf),
        jnp.where(found, best, -1),
        jnp.where(found, u[r, best], 0.0),
        jnp.where(found, v[r, best], 0.0),
    )
