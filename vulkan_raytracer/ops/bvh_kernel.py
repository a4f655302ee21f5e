"""Per-ray threaded-BVH traversal as one fused GPU kernel (Pallas, Triton).

The reference hands every ``traceRayEXT`` to the driver's per-ray BVH walk
(shaders/raygen.rgen:59).  The XLA walk in :mod:`.traverse` expresses the
same walk over a whole wavefront, but XLA cannot fuse a data-dependent
per-lane loop: every step runs as separate kernels over the full band with
the ray state round-tripping through device memory.  This kernel keeps the
state in registers instead:

* each program takes a power-of-two block of rays; every lane walks the
  threaded (stackless) BVH of :mod:`vulkan_raytracer.accel.bvh` with its own
  int32 cursor inside one in-kernel ``lax.while_loop``, and the block
  finishes when its own lanes do;
* a node is one packed 32-byte row (``ThreadedBVH.node_rows``) and a leaf
  triangle one 9-float row (``ThreadedBVH.tri_rows``), so a visit reads each
  record with per-lane gathers from one place instead of several columns;
* the leaf's live-slot count rides in the node row, so padded slots are
  never loaded.

The visiting order, the interval tests and the closest-hit tie rule are
those of :func:`.traverse.trace_closest` / :func:`.traverse.trace_shadow`,
which stay the plain reference.  Alpha semantics live in the integrator's
resample loop, so the kernel treats every triangle as a candidate.

:func:`bvh_closest` / :func:`bvh_shadow` are the dispatch points the
renderer calls: the compiled kernel on a GPU backend, the XLA reference
everywhere else.  ``interpret=True`` (tests only) runs the kernel through
the Pallas interpreter on any backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .traverse import trace_closest, trace_shadow

#: rays per program (power of two) and warps per program: one warp of 32
#: lanes per program measured fastest on the H100 (PERF.md, PR 1)
BLOCK = 32
NUM_WARPS = 1

#: name of the compiled kernels (visible in lowered/compiled HLO text)
KERNEL_NAME = "vkrt_bvh_walk"

_TINY = 1e-20


def kernel_mode() -> str | None:
    """How :func:`bvh_closest` / :func:`bvh_shadow` trace: ``"compiled"``
    on a GPU backend, ``None`` (the XLA reference) elsewhere.  Tests
    replace this function to drive the kernel through the interpreter."""
    return "compiled" if jax.default_backend() == "gpu" else None


def _safe_inv(x):
    # == intersect.safe_inv_dir, per component
    return 1.0 / jnp.where(jnp.abs(x) < _TINY, jnp.where(x < 0, -_TINY, _TINY), x)


def _walk_kernel(nodes_ref, tris_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
                 dz_ref, tlo_ref, thi_ref, *out_refs, n_nodes, leaf_size,
                 shadow):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv = tuple(_safe_inv(c) for c in d)
    t_lo = tlo_ref[...]
    t_hi = thi_ref[...]
    end = jnp.int32(n_nodes)
    kbits = leaf_size.bit_length() - 1

    def node(base, k, m):
        return pltriton.load(nodes_ref.at[base + k], mask=m, other=0.0)

    def tri(row, k, m):
        return pltriton.load(tris_ref.at[row + k], mask=m, other=0.0)

    def cond(c):
        return jnp.max(jnp.where(c[0] < end, 1, 0)) > 0

    def body(c):
        cur = c[0]
        t_best = t_hi if shadow else c[1]
        in_node = cur < end
        base = jnp.minimum(cur, end - 1) * 8
        # slab test (== intersect.ray_aabb)
        tnear = tfar = None
        for k in range(3):
            t0 = (node(base, k, in_node) - o[k]) * inv[k]
            t1 = (node(base, k + 3, in_node) - o[k]) * inv[k]
            lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
            tnear = lo if tnear is None else jnp.maximum(tnear, lo)
            tfar = hi if tfar is None else jnp.minimum(tfar, hi)
        code = jax.lax.bitcast_convert_type(node(base, 6, in_node), jnp.int32)
        miss = jax.lax.bitcast_convert_type(node(base, 7, in_node), jnp.int32)
        if shadow:
            box_lo, box_hi = 0.0, t_hi
        else:
            box_lo, box_hi = t_lo, t_best
        hit_box = (in_node & (tnear <= tfar) & (tfar >= box_lo)
                   & (tnear <= box_hi))
        is_leaf = code >= 0
        do_leaf = hit_box & is_leaf
        first = (code >> kbits) << kbits
        count = (code & (leaf_size - 1)) + 1

        if shadow:
            occ = c[1]
        else:
            slot, ub, vb = c[2], c[3], c[4]
        for j in range(leaf_size):
            m = do_leaf & (j < count)
            row = (first + j) * 9
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tri(row, k, m) for k in range(9))
            # Moller-Trumbore (== intersect.ray_triangle)
            px = d[1] * e2z - d[2] * e2y
            py = d[2] * e2x - d[0] * e2z
            pz = d[0] * e2y - d[1] * e2x
            det = e1x * px + e1y * py + e1z * pz
            near_zero = jnp.abs(det) < 1e-12
            inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
            tx, ty, tz = o[0] - v0x, o[1] - v0y, o[2] - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            ok = (m & ~near_zero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
            if shadow:
                occ = occ | (ok & (t > 0.0) & (t <= t_hi))
            else:
                closer = ok & (t > t_lo) & (t < t_best)
                t_best = jnp.where(closer, t, t_best)
                slot = jnp.where(closer, first + j, slot)
                ub = jnp.where(closer, u, ub)
                vb = jnp.where(closer, v, vb)

        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, miss)
        live = in_node & ~occ if shadow else in_node
        nxt = jnp.where(live, nxt, end)
        if shadow:
            return nxt, occ
        return nxt, t_best, slot, ub, vb

    cur0 = jnp.where(t_hi >= 0.0, 0, end).astype(jnp.int32)
    if shadow:
        init = (cur0, jnp.zeros(t_hi.shape, jnp.bool_))
        _, occ = jax.lax.while_loop(cond, body, init)
        out_refs[0][...] = occ.astype(jnp.int32)
    else:
        zeros = jnp.zeros(t_hi.shape, jnp.float32)
        init = (cur0, t_hi, jnp.full(t_hi.shape, -1, jnp.int32), zeros, zeros)
        _, t_best, slot, ub, vb = jax.lax.while_loop(cond, body, init)
        t_ref, slot_ref, u_ref, v_ref = out_refs
        t_ref[...] = t_best
        slot_ref[...] = slot
        u_ref[...] = ub
        v_ref[...] = vb


@functools.partial(
    jax.jit, static_argnames=("shadow", "interpret", "block", "num_warps"))
def _walk(bvh, rays, t_lo, t_hi, *, shadow, interpret, block, num_warps):
    """Run the kernel over (n_pad,) lane arrays (n_pad a multiple of block);
    dead lanes carry ``t_hi < 0``."""
    n_pad = t_hi.shape[0]
    nodes = bvh.node_rows.reshape(-1)
    tris = bvh.tri_rows.reshape(-1)
    lane = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))  # noqa: E731
    if shadow:
        out_shape = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
        out_specs = lane
    else:
        out_shape = (
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        )
        out_specs = (lane,) * 4
    kernel = functools.partial(
        _walk_kernel, n_nodes=bvh.num_nodes, leaf_size=bvh.leaf_size,
        shadow=shadow)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // block,),
        in_specs=[whole(nodes), whole(tris)] + [lane] * 8,
        out_specs=out_specs,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name=KERNEL_NAME + ("_shadow" if shadow else "_closest"),
    )(nodes, tris, *rays, t_lo, t_hi)


def _lanes(o, d, t_min, t_max, active, block):
    """Pad ray lanes to a multiple of ``block``; padding lanes are dead."""
    n = o[0].shape[0]
    n_pad = -(-n // block) * block

    def pad(x, fill=0.0):
        x = jnp.broadcast_to(jnp.asarray(x, jnp.float32), (n,))
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)

    rays = tuple(pad(c) for c in (*o, *d))
    t_hi = jnp.where(active, jnp.asarray(t_max, jnp.float32), -1.0)
    return rays, pad(t_min), pad(t_hi, -1.0), n


def _comps(v):
    return (v.x, v.y, v.z) if hasattr(v, "x") else tuple(v[:, k] for k in range(3))


def kernel_closest(bvh, o, d, *, t_min, t_max, active, interpret=False,
                   block=BLOCK, num_warps=NUM_WARPS):
    """Closest hit; same contract as :func:`.traverse.trace_closest` without
    alpha: returns (t, tri, u, v), t=+inf and tri=-1 on miss.

    ``o``/``d`` are V3 component triples or (N, 3) arrays; ``t_min`` and
    ``t_max`` are scalars or per-lane (N,) arrays; ``active`` is (N,) bool.
    """
    rays, t_lo, t_hi, n = _lanes(_comps(o), _comps(d), t_min, t_max, active,
                                 block)
    t, slot, u, v = _walk(bvh, rays, t_lo, t_hi, shadow=False,
                          interpret=interpret, block=block,
                          num_warps=num_warps)
    t, slot, u, v = t[:n], slot[:n], u[:n], v[:n]
    found = slot >= 0
    tri = jnp.where(found, jnp.take(bvh.tri_id, jnp.maximum(slot, 0)), -1)
    return (jnp.where(found, t, jnp.inf), tri, jnp.where(found, u, 0.0),
            jnp.where(found, v, 0.0))


def kernel_shadow(bvh, o, d, *, t_max, active, interpret=False, block=BLOCK,
                  num_warps=NUM_WARPS):
    """Terminate-on-first-hit occlusion over (0, t_max]; same contract as
    :func:`.traverse.trace_shadow` without alpha.  Returns (N,) bool."""
    rays, t_lo, t_hi, n = _lanes(_comps(o), _comps(d), 0.0, t_max, active,
                                 block)
    occ = _walk(bvh, rays, t_lo, t_hi, shadow=True, interpret=interpret,
                block=block, num_warps=num_warps)
    return occ[:n] > 0


def bvh_closest(bvh, o, d, *, t_min, t_max, active):
    """Closest hit over ``bvh``: the kernel where :func:`kernel_mode` says
    so, else the XLA reference walk.  Returns (t, tri, u, v)."""
    mode = kernel_mode()
    if mode is None:
        res, _ = trace_closest(bvh, o.to_array(), d.to_array(), t_min=t_min,
                               t_max=t_max, active=active)
        return res
    return kernel_closest(bvh, o, d, t_min=t_min, t_max=t_max, active=active,
                          interpret=mode == "interpret")


def bvh_shadow(bvh, o, d, *, t_max, active):
    """Occlusion over ``bvh`` (tMin = 0): the kernel where
    :func:`kernel_mode` says so, else the XLA reference walk."""
    mode = kernel_mode()
    if mode is None:
        occ, _ = trace_shadow(bvh, o.to_array(), d.to_array(), t_max=t_max,
                              active=active)
        return occ
    return kernel_shadow(bvh, o, d, t_max=t_max, active=active,
                         interpret=mode == "interpret")
