"""3-D DDA traversal of the uniform grid — lockstep-friendly tracing.

Every while-loop iteration performs the same masked work on every lane:
test up to ``K`` triangles of the lane's current cell (flat 1-D gathers +
component-form Möller-Trumbore), then advance exhausted lanes one cell
along the ray (Amanatides & Woo stepping).  No per-lane control flow ever
diverges in *instructions*, only in masks.

Closest-hit early termination: a lane stops marching once its best hit is
closer than the entry of the next cell.  Triangles spanning several cells
are tested more than once — harmless for closest-hit/occlusion (the MIS
pdf probe, which must count each emissive intersection exactly once, uses
the dense path instead — see integrator._emissive_pdf).

Alpha semantics match the BVH path (hit.rahit:45-53): deterministic MASK
rejection and stochastic BLEND with one rnd per candidate intersection.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rng
from .math3 import V3, v3_gather

#: triangles tested per lane per loop iteration
K = 8

_BIG = jnp.float32(3e38)


def _grid_enter(grid, o: V3, d: V3, t_min):
    """Clip rays to the grid AABB; returns (t0, inside, inv_d...)."""
    gx, gy, gz = grid.origin
    cx, cy, cz = grid.cell_size
    rx, ry, rz = grid.res
    hix = gx + cx * rx
    hiy = gy + cy * ry
    hiz = gz + cz * rz

    def axis(o_, d_, lo, hi):
        tiny = 1e-20
        d_safe = jnp.where(jnp.abs(d_) < tiny, jnp.where(d_ < 0, -tiny, tiny), d_)
        inv = 1.0 / d_safe
        ta = (lo - o_) * inv
        tb = (hi - o_) * inv
        return jnp.minimum(ta, tb), jnp.maximum(ta, tb), inv

    nx, fx, ix = axis(o.x, d.x, gx, hix)
    ny, fy, iy = axis(o.y, d.y, gy, hiy)
    nz, fz, iz = axis(o.z, d.z, gz, hiz)
    tnear = jnp.maximum(jnp.maximum(nx, ny), nz)
    tfar = jnp.minimum(jnp.minimum(fx, fy), fz)
    t0 = jnp.maximum(tnear, t_min)
    inside = (tnear <= tfar) & (tfar >= t_min)
    return t0, tfar, inside, (ix, iy, iz)


def _init_state(grid, o: V3, d: V3, t_min, active):
    rx, ry, rz = grid.res
    gx, gy, gz = grid.origin
    cx, cy, cz = grid.cell_size
    t0, tfar, inside, (ix, iy, iz) = _grid_enter(grid, o, d, t_min)
    alive = active & inside

    px = o.x + t0 * d.x
    py = o.y + t0 * d.y
    pz = o.z + t0 * d.z
    ci = jnp.clip(jnp.floor((px - gx) / cx).astype(jnp.int32), 0, rx - 1)
    cj = jnp.clip(jnp.floor((py - gy) / cy).astype(jnp.int32), 0, ry - 1)
    ck = jnp.clip(jnp.floor((pz - gz) / cz).astype(jnp.int32), 0, rz - 1)

    def tmax_axis(o_, d_, inv, c, g, cs):
        nxt = g + (c.astype(jnp.float32) + (d_ > 0)) * cs
        tm = (nxt - o_) * inv
        return jnp.where(jnp.abs(d_) < 1e-20, _BIG, tm)

    tmx = tmax_axis(o.x, d.x, ix, ci, gx, cx)
    tmy = tmax_axis(o.y, d.y, iy, cj, gy, cy)
    tmz = tmax_axis(o.z, d.z, iz, ck, gz, cz)
    tdx = jnp.where(jnp.abs(d.x) < 1e-20, _BIG, jnp.abs(cx * ix))
    tdy = jnp.where(jnp.abs(d.y) < 1e-20, _BIG, jnp.abs(cy * iy))
    tdz = jnp.where(jnp.abs(d.z) < 1e-20, _BIG, jnp.abs(cz * iz))
    sx = jnp.where(d.x > 0, 1, -1).astype(jnp.int32)
    sy = jnp.where(d.y > 0, 1, -1).astype(jnp.int32)
    sz = jnp.where(d.z > 0, 1, -1).astype(jnp.int32)

    cell = (ci * ry + cj) * rz + ck
    base = jnp.take(grid.cell_start, jnp.maximum(cell, 0), axis=0)
    cnt = jnp.take(grid.cell_start, jnp.maximum(cell, 0) + 1, axis=0) - base
    cnt = jnp.where(alive, cnt, 0)
    return dict(
        alive=alive,
        ci=ci, cj=cj, ck=ck,
        tmx=tmx, tmy=tmy, tmz=tmz,
        base=base, cnt=cnt, off=jnp.zeros_like(base),
        tfar=tfar,
    ), (tdx, tdy, tdz), (sx, sy, sz)


def _advance(grid, s, td, sgn):
    """DDA-step lanes whose cell is exhausted; returns updated state parts."""
    rx, ry, rz = grid.res
    tdx, tdy, tdz = td
    sx, sy, sz = sgn
    adv = s["alive"] & (s["off"] >= s["cnt"])
    pick_x = (s["tmx"] <= s["tmy"]) & (s["tmx"] <= s["tmz"])
    pick_y = ~pick_x & (s["tmy"] <= s["tmz"])
    pick_z = ~pick_x & ~pick_y
    t_next = jnp.minimum(jnp.minimum(s["tmx"], s["tmy"]), s["tmz"])

    ci = s["ci"] + jnp.where(adv & pick_x, sx, 0)
    cj = s["cj"] + jnp.where(adv & pick_y, sy, 0)
    ck = s["ck"] + jnp.where(adv & pick_z, sz, 0)
    tmx = s["tmx"] + jnp.where(adv & pick_x, tdx, 0.0)
    tmy = s["tmy"] + jnp.where(adv & pick_y, tdy, 0.0)
    tmz = s["tmz"] + jnp.where(adv & pick_z, tdz, 0.0)
    out = (ci < 0) | (ci >= rx) | (cj < 0) | (cj >= ry) | (ck < 0) | (ck >= rz)
    alive_after = s["alive"] & ~(adv & out)

    cell = (jnp.clip(ci, 0, rx - 1) * ry + jnp.clip(cj, 0, ry - 1)) * rz + jnp.clip(
        ck, 0, rz - 1
    )
    nbase = jnp.take(grid.cell_start, cell, axis=0)
    ncnt = jnp.take(grid.cell_start, cell + 1, axis=0) - nbase
    base = jnp.where(adv, nbase, s["base"])
    cnt = jnp.where(adv & alive_after, ncnt, jnp.where(adv, 0, s["cnt"]))
    off = jnp.where(adv, 0, s["off"])
    return adv, t_next, dict(
        s,
        alive=alive_after,
        ci=ci, cj=cj, ck=ck,
        tmx=tmx, tmy=tmy, tmz=tmz,
        base=base, cnt=cnt, off=off,
    )


def _test_k(tables, grid, o, d, s, t_min, t_best, tri_best, seed, alpha, want_occ, t_ray_max):
    """Test up to K triangles of the current cell per lane.

    All candidate data is fetched with (K, N)-index batched gathers (one
    gather per component, not one per candidate) and the MT math runs on
    (K, N) triangles-major tiles — gather *latency*, not bandwidth, is the
    cost on this path.
    """
    has = s["alive"] & (s["off"] < s["cnt"])
    krow = jnp.arange(K, dtype=jnp.int32)[:, None]
    slot = jnp.clip(
        s["base"][None, :] + s["off"][None, :] + krow, 0, grid.tri_ids.shape[0] - 1
    )
    valid = has[None, :] & (s["off"][None, :] + krow < s["cnt"][None, :])
    tid = jnp.take(grid.tri_ids, slot, axis=0)  # (K, N)

    gk = lambda col: jnp.take(col, tid, axis=0)
    v0x, v0y, v0z = gk(tables.v0.x), gk(tables.v0.y), gk(tables.v0.z)
    e1x = gk(tables.v1.x) - v0x
    e1y = gk(tables.v1.y) - v0y
    e1z = gk(tables.v1.z) - v0z
    e2x = gk(tables.v2.x) - v0x
    e2y = gk(tables.v2.y) - v0y
    e2z = gk(tables.v2.z) - v0z

    ox, oy, oz = o.x[None, :], o.y[None, :], o.z[None, :]
    dx, dy, dz = d.x[None, :], d.y[None, :], d.z[None, :]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    near0 = jnp.abs(det) < 1e-12
    inv = 1.0 / jnp.where(near0, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    bound = jnp.minimum(t_best, t_ray_max)[None, :]
    hit = (
        valid
        & ~near0
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t <= bound)
    )
    if alpha is not None:
        mode = jnp.take(alpha.mode, tid, axis=0)
        aval = jnp.take(alpha.value, tid, axis=0)
        acut = jnp.take(alpha.cutoff, tid, axis=0)
        hit = hit & ~((mode == 1) & (aval < acut))
        is_blend = hit & (mode == 2)
        # one rnd per BLEND candidate, consumed sequentially per row to
        # match the per-intersection draw semantics (hit.rahit:52)
        for k in range(K):
            u01, seed_adv = rng.rnd(seed)
            seed = jnp.where(is_blend[k], seed_adv, seed)
            hit = hit.at[k].set(hit[k] & ~(is_blend[k] & (u01 < 1.0 - aval[k])))
    # fold the K candidates to the closest (duplicate-safe: min over t)
    t_masked = jnp.where(hit, t, _BIG)
    t_min_k = jnp.min(t_masked, axis=0)
    any_hit = jnp.any(hit, axis=0)
    krow_best = jnp.argmin(t_masked, axis=0)
    tid_best = jnp.take_along_axis(tid, krow_best[None, :], axis=0)[0]
    closer = any_hit & (t_min_k < t_best)
    t_best = jnp.where(closer, t_min_k, t_best)
    tri_best = jnp.where(closer, tid_best, tri_best)
    off = jnp.where(has, s["off"] + K, s["off"])
    return dict(s, off=off), t_best, tri_best, seed


def _iter_cap(grid) -> int:
    """Safety bound: longest cell path times iterations per cell."""
    rx, ry, rz = grid.res
    per_cell = max(1, grid.max_per_cell // K + 2)
    return (rx + ry + rz + 4) * per_cell


def grid_closest(tables, grid, o: V3, d: V3, *, t_min, t_max, active, seed=None, alpha=None):
    """Closest-hit via grid DDA; same contract as dense/trace closest."""
    n = o.x.shape[0]
    if seed is None:
        seed = jnp.zeros((n,), jnp.uint32)
    t_ray_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    s, td, sgn = _init_state(grid, o, d, t_min, active)
    cap = _iter_cap(grid)

    carry = dict(
        s=s,
        t_best=jnp.full((n,), jnp.inf, jnp.float32),
        tri=jnp.full((n,), -1, jnp.int32),
        seed=seed,
        it=jnp.int32(0),
    )

    def cond(c):
        return jnp.any(c["s"]["alive"]) & (c["it"] < cap)

    def body(c):
        s = c["s"]
        s, t_best, tri, seed = _test_k(
            tables, grid, o, d, s, t_min, c["t_best"], c["tri"], c["seed"], alpha,
            False, t_ray_max,
        )
        adv, t_next, s = _advance(grid, s, td, sgn)
        # early termination: best hit closer than the next cell's entry, or
        # the march has passed the ray's t_max
        done = adv & (
            (t_best <= t_next) | (t_next > t_ray_max) | (t_next > s["tfar"])
        )
        s = dict(s, alive=s["alive"] & ~done)
        return dict(s=s, t_best=t_best, tri=tri, seed=seed, it=c["it"] + 1)

    out = jax.lax.while_loop(cond, body, carry)
    tri = out["tri"]
    t_best = out["t_best"]
    found = tri >= 0

    # recompute (u, v) for the winning triangle
    ti = jnp.maximum(tri, 0)
    wv0 = v3_gather(tables.v0, ti)
    e1 = v3_gather(tables.v1, ti) - wv0
    e2 = v3_gather(tables.v2, ti) - wv0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tvec = o - wv0
    u = tvec.dot(pvec) * inv
    v = d.dot(tvec.cross(e1)) * inv

    return (
        jnp.where(found, t_best, jnp.inf),
        tri,
        jnp.where(found, u, 0.0),
        jnp.where(found, v, 0.0),
    ), out["seed"]


def grid_shadow(tables, grid, o: V3, d: V3, *, t_max, active, seed=None, alpha=None):
    """Occlusion via grid DDA: true iff ANY accepted hit lies in (0, t_max)."""
    n = o.x.shape[0]
    if seed is None:
        seed = jnp.zeros((n,), jnp.uint32)
    t_ray_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    s, td, sgn = _init_state(grid, o, d, 0.0, active)

    cap = _iter_cap(grid)
    carry = dict(
        s=s,
        t_best=t_ray_max,  # any hit must beat t_max
        tri=jnp.full((n,), -1, jnp.int32),
        seed=seed,
        it=jnp.int32(0),
    )

    def cond(c):
        return jnp.any(c["s"]["alive"]) & (c["it"] < cap)

    def body(c):
        s = c["s"]
        s, t_best, tri, seed = _test_k(
            tables, grid, o, d, s, 0.0, c["t_best"], c["tri"], c["seed"], alpha,
            True, t_ray_max,
        )
        occluded_now = tri >= 0
        adv, t_next, s = _advance(grid, s, td, sgn)
        done = occluded_now | (
            adv & ((t_next > t_ray_max) | (t_next > s["tfar"]))
        )
        s = dict(s, alive=s["alive"] & ~done)
        return dict(s=s, t_best=t_best, tri=tri, seed=seed, it=c["it"] + 1)

    out = jax.lax.while_loop(cond, body, carry)
    return (out["tri"] >= 0) & active, out["seed"]
