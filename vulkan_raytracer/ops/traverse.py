"""Stackless wavefront BVH traversal in XLA — the plain reference walk.

The reference dispatches one hardware BVH walk per shader thread
(shaders/raygen.rgen:59, lightsample.glsl:27,131,136).  Here a whole ray
wavefront traverses together: per-ray state is one int32 node cursor into
the threaded BVH (see :mod:`vulkan_raytracer.accel.bvh`), the walk is a
single ``lax.while_loop`` over vectorised gathers, and leaf intersection is
a statically unrolled batch of ``leaf_size`` Möller–Trumbore tests.

Three traversal modes mirror the reference's ray kinds (no function
pointers — each mode is its own specialised compilation):

* :func:`trace_closest` — material & emissive-verify rays (hit groups 0/2),
  including the stochastic alpha-mask/blend any-hit semantics of
  shaders/hit.rahit:45-53.
* :func:`trace_shadow` — terminate-on-first-hit occlusion rays
  (gl_RayFlagsTerminateOnFirstHitEXT, lightsample.glsl:27,44).
* :func:`trace_emissive_pdf` — the MIS pdf-accumulation probe
  (shaders/emissivepdf.rahit:57-67): walks an *emissive-only* BVH (our
  equivalent of cullMask bit 1, accelerationstructure.cpp:167-169) and sums
  the solid-angle pdf of every emissive triangle along the ray.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import rng
from .intersect import ray_aabb, ray_triangle, safe_inv_dir


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AlphaTables:
    """Per-original-triangle alpha-test data (material.h:7-8 flattened).

    mode: 0=OPAQUE, 1=MASK, 2=BLEND (scene.cpp:169-176); value is the
    baseColourFactor alpha; cutoff the MASK threshold.  The render path
    handles alpha (including texture-modulated alpha) in the integrator's
    t-ordered resample loop (render/integrator.py:_closest); the in-
    traversal alpha here remains for the standalone traversal API.
    """

    mode: jax.Array  # (T,) i32
    value: jax.Array  # (T,) f32
    cutoff: jax.Array  # (T,) f32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EmissivePDFTables:
    """Per-emissive-triangle data for the MIS pdf probe.

    Indexed by the emissive BVH's ``tri_id`` (= global emissive-triangle
    CDF row).  ``p_delta`` is the normalised CDF increment
    (emissivepdf.rahit:62-64); ``area`` the world-space triangle area;
    n0/n1/n2 the (unnormalised, world-space) vertex normals used for the
    cosine term (emissivepdf.rahit:52-53).
    """

    p_delta: jax.Array  # (Te,) f32
    area: jax.Array  # (Te,) f32
    n0: jax.Array  # (Te, 3) f32
    n1: jax.Array  # (Te, 3) f32
    n2: jax.Array  # (Te, 3) f32


def _node_fetch(bvh, cur):
    """Gather node data for the current cursor, clamped for masked lanes."""
    ci = jnp.minimum(cur, bvh.num_nodes - 1)
    return (
        jnp.take(bvh.aabb_min, ci, axis=0),
        jnp.take(bvh.aabb_max, ci, axis=0),
        jnp.take(bvh.first_tri, ci, axis=0),
        jnp.take(bvh.miss, ci, axis=0),
    )


def _leaf_gather(bvh, first):
    """Gather the leaf's padded triangle block: (N, K, 3) verts + (N, K) ids."""
    k = bvh.leaf_size
    idx = jnp.maximum(first, 0)[:, None] + jnp.arange(k, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(idx, bvh.num_tri_slots - 1)
    return (
        jnp.take(bvh.tri_v0, idx, axis=0),
        jnp.take(bvh.tri_e1, idx, axis=0),
        jnp.take(bvh.tri_e2, idx, axis=0),
        jnp.take(bvh.tri_id, idx, axis=0),
    )


def _alpha_ignore(alpha: AlphaTables, tid, cand, seed):
    """Vectorised port of the any-hit alpha test (shaders/hit.rahit:45-53).

    Draws one rnd per BLEND-material candidate intersection (C short-circuit
    in the reference: rnd is evaluated iff alphaMode==2), threading the seed
    with the select rule so per-lane streams match a scalar interpreter.
    Returns (keep_mask, seed).
    """
    ti = jnp.maximum(tid, 0)
    mode = jnp.take(alpha.mode, ti, axis=0)
    aval = jnp.take(alpha.value, ti, axis=0)
    acut = jnp.take(alpha.cutoff, ti, axis=0)
    keep = cand
    k = tid.shape[1]
    for j in range(k):
        cand_j = cand[:, j]
        is_blend = cand_j & (mode[:, j] == 2)
        u, seed_adv = rng.rnd(seed)
        seed = jnp.where(is_blend, seed_adv, seed)
        ignore = (cand_j & (mode[:, j] == 1) & (aval[:, j] < acut[:, j])) | (
            is_blend & (u < 1.0 - aval[:, j])
        )
        keep = keep.at[:, j].set(cand_j & ~ignore)
    return keep, seed


def trace_closest(bvh, o, d, *, t_min, t_max, active, seed=None, alpha=None):
    """Closest-hit traversal (material rays, emissive-verify rays).

    Args:
      o, d: (N, 3) rays (d may be non-unit; t is in |d| units, matching the
        reference's traceRayEXT semantics).
      t_min: scalar minimum t (EPS for material rays, raygen.rgen:59).
      t_max: scalar or (N,) maximum t.
      active: (N,) bool — lanes to trace.
      seed / alpha: uint32 RNG lanes + alpha tables for stochastic any-hit;
        pass None for fully opaque scenes (statically removes the work).

    Returns ((t, tri, u, v), seed): t=+inf and tri=-1 on miss; (u, v) are the
    Vulkan hit attributes with weights (1-u-v, u, v) (hit.rchit:117).
    """
    n = o.shape[0]
    end = bvh.num_nodes
    inv_d = safe_inv_dir(d)
    t_bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    # t_min may be per-lane (the integrator's alpha resample loop)
    t_lo = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    if seed is None:
        seed = jnp.zeros((n,), jnp.uint32)

    def cond(c):
        return jnp.any(c["cur"] < end)

    def body(c):
        cur = c["cur"]
        in_node = cur < end
        bmin, bmax, first, miss = _node_fetch(bvh, cur)
        hit_box = in_node & ray_aabb(o, inv_d, bmin, bmax, t_lo, c["t"])
        is_leaf = first >= 0
        do_leaf = hit_box & is_leaf

        tv0, te1, te2, tid = _leaf_gather(bvh, first)
        hit, t, u, v = ray_triangle(
            o[:, None, :], d[:, None, :], tv0, te1, te2, t_lo[:, None], c["t"][:, None]
        )
        cand = do_leaf[:, None] & hit & (tid >= 0)
        s = c["seed"]
        if alpha is not None:
            cand, s = _alpha_ignore(alpha, tid, cand, s)

        t_best, tri, ub, vb = c["t"], c["tri"], c["u"], c["v"]
        for j in range(bvh.leaf_size):
            closer = cand[:, j] & (t[:, j] < t_best)
            t_best = jnp.where(closer, t[:, j], t_best)
            tri = jnp.where(closer, tid[:, j], tri)
            ub = jnp.where(closer, u[:, j], ub)
            vb = jnp.where(closer, v[:, j], vb)

        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, miss)
        nxt = jnp.where(in_node, nxt, end)
        return dict(cur=nxt, t=t_best, tri=tri, u=ub, v=vb, seed=s)

    init = dict(
        cur=jnp.where(active, 0, end).astype(jnp.int32),
        t=t_bound,
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
        seed=seed,
    )
    out = jax.lax.while_loop(cond, body, init)
    found = out["tri"] >= 0
    t_final = jnp.where(found, out["t"], jnp.inf)
    return (t_final, out["tri"], out["u"], out["v"]), out["seed"]


def trace_shadow(bvh, o, d, *, t_max, active, seed=None, alpha=None):
    """Occlusion traversal: true if ANY accepted hit lies in (0, t_max).

    Mirrors the reference shadow ray — TerminateOnFirstHit, tMin=0
    (lightsample.glsl:27,44) with shadow.rahit alpha semantics.  Lanes stop
    walking the tree as soon as they are occluded.

    Returns (occluded, seed).
    """
    n = o.shape[0]
    end = bvh.num_nodes
    inv_d = safe_inv_dir(d)
    t_bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    if seed is None:
        seed = jnp.zeros((n,), jnp.uint32)

    def cond(c):
        return jnp.any(c["cur"] < end)

    def body(c):
        cur = c["cur"]
        in_node = cur < end
        bmin, bmax, first, miss = _node_fetch(bvh, cur)
        hit_box = in_node & ray_aabb(o, inv_d, bmin, bmax, 0.0, t_bound)
        is_leaf = first >= 0
        do_leaf = hit_box & is_leaf

        tv0, te1, te2, tid = _leaf_gather(bvh, first)
        hit, _, _, _ = ray_triangle(
            o[:, None, :], d[:, None, :], tv0, te1, te2, 0.0, t_bound[:, None]
        )
        cand = do_leaf[:, None] & hit & (tid >= 0)
        s = c["seed"]
        if alpha is not None:
            cand, s = _alpha_ignore(alpha, tid, cand, s)
        occluded = c["occ"] | jnp.any(cand, axis=1)

        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, miss)
        nxt = jnp.where(in_node & ~occluded, nxt, end)  # early out
        return dict(cur=nxt, occ=occluded, seed=s)

    init = dict(
        cur=jnp.where(active, 0, end).astype(jnp.int32),
        occ=jnp.zeros((n,), bool),
        seed=seed,
    )
    out = jax.lax.while_loop(cond, body, init)
    return out["occ"], out["seed"]


def trace_emissive_pdf(ebvh, tables: EmissivePDFTables, o, d, *, t_min, active):
    """MIS pdf probe: sum pdf over every emissive triangle along the ray.

    Port of shaders/emissivepdf.rahit:57-67 — per intersection adds
    ``p_delta * t^2 / (area * dot(n_flip, -d))`` where ``n_flip`` is the
    interpolated vertex normal flipped towards the ray origin, then ignores
    the intersection so traversal continues.  ``ebvh`` must be the BVH over
    emissive triangles only (the cullMask bit-1 equivalent); ray extent is
    (t_min, INF) (raygen.rgen:70, lightsample.glsl:136).

    Returns pdf (N,) f32.
    """
    n = o.shape[0]
    end = ebvh.num_nodes
    inv_d = safe_inv_dir(d)
    inf = jnp.float32(1e32)

    def cond(c):
        return jnp.any(c["cur"] < end)

    def body(c):
        cur = c["cur"]
        in_node = cur < end
        bmin, bmax, first, miss = _node_fetch(ebvh, cur)
        hit_box = in_node & ray_aabb(o, inv_d, bmin, bmax, t_min, inf)
        is_leaf = first >= 0
        do_leaf = hit_box & is_leaf

        tv0, te1, te2, tid = _leaf_gather(ebvh, first)
        hit, t, u, v = ray_triangle(
            o[:, None, :], d[:, None, :], tv0, te1, te2, t_min, inf
        )
        cand = do_leaf[:, None] & hit & (tid >= 0)

        ti = jnp.maximum(tid, 0)
        p = jnp.take(tables.p_delta, ti, axis=0)
        area = jnp.take(tables.area, ti, axis=0)
        n0 = jnp.take(tables.n0, ti, axis=0)
        n1 = jnp.take(tables.n1, ti, axis=0)
        n2 = jnp.take(tables.n2, ti, axis=0)
        w0 = (1.0 - u - v)[..., None]
        nrm = w0 * n0 + u[..., None] * n1 + v[..., None] * n2
        nrm = nrm / jnp.maximum(
            jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20
        )
        # dot(n_flip, -d) = |dot(n_hat, d)| (emissivepdf.rahit:53,65)
        cosine = jnp.abs(jnp.sum(nrm * d[:, None, :], axis=-1))
        contrib = p * t * t / jnp.maximum(area * cosine, 1e-30)
        pdf = c["pdf"] + jnp.sum(jnp.where(cand, contrib, 0.0), axis=1)

        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, miss)
        nxt = jnp.where(in_node, nxt, end)
        return dict(cur=nxt, pdf=pdf)

    init = dict(
        cur=jnp.where(active, 0, end).astype(jnp.int32),
        pdf=jnp.zeros((n,), jnp.float32),
    )
    return jax.lax.while_loop(cond, body, init)["pdf"]
