"""Software bounding-volume hierarchy replacing VK_KHR_acceleration_structure.

The reference delegates BLAS/TLAS construction and traversal to the Vulkan
driver (src/accelerationstructure.cpp:85-229).  Here we build our own:

* **Flattened one-level world-space BVH.**  The reference's two-level
  BLAS-per-primitive / TLAS-over-instances split exists to support instancing
  and refit (accelerationstructure.cpp:26-32), but its render loop never
  mutates the scene after load (SURVEY.md §3.5).  We therefore pre-transform
  every instance's triangles to world space at upload time and build a single
  BVH over all of them — one traversal loop instead of a nested TLAS->BLAS
  walk.  ``rebuild()`` re-flattens,
  providing the same update entry point.

* **Threaded (skip-pointer) layout for stackless traversal.**  Nodes are
  stored in DFS preorder.  An AABB hit on an interior node advances to
  ``i+1`` (its left child); a miss — or a processed leaf — jumps to
  ``miss[i]``, the preorder index just past the node's subtree.  Per-ray
  traversal state is then a single int32, so a whole wavefront of rays walks
  the tree inside one ``lax.while_loop`` with no per-lane stacks.

* **Fixed-arity leaves.**  Every leaf owns exactly ``leaf_size`` padded
  triangle slots stored contiguously (live triangles first), so leaf
  intersection is a statically unrolled batch of Möller–Trumbore tests.

* **Packed rows for per-lane gathers.**  Besides the columns, every node is
  one 32-byte row ``[min xyz, max xyz, code, miss]`` (the two int32 fields
  bit-cast into the f32 row; ``code`` is ``first | (count - 1)`` for a leaf
  of ``count`` live slots, -1 for an interior node) and every triangle slot
  one 9-float row ``[v0, e1, e2]``, so the GPU kernel
  (:mod:`vulkan_raytracer.ops.bvh_kernel`) reads a visit's data from one
  place.

The builder runs in NumPy on the host (scene load is host-side in the
reference too, scene.cpp:23-143); traversal is pure JAX
(:mod:`vulkan_raytracer.ops.traverse`).
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ThreadedBVH:
    """Flattened threaded BVH plus its leaf-reordered triangle soup.

    ``first_tri[i] >= 0`` marks a leaf and indexes the first of ``leaf_size``
    contiguous slots in the padded triangle arrays; interior nodes store -1.
    ``miss[i]`` is the skip pointer; a value of ``num_nodes`` exits traversal.
    ``tri_id`` maps padded slots back to the caller's original triangle
    numbering (-1 for padding), so per-triangle payloads (materials, emissive
    CDF rows, ...) stay in scene order.
    """

    aabb_min: jax.Array  # (Nn, 3) f32
    aabb_max: jax.Array  # (Nn, 3) f32
    first_tri: jax.Array  # (Nn,) i32
    miss: jax.Array  # (Nn,) i32
    tri_v0: jax.Array  # (Nt, 3) f32
    tri_e1: jax.Array  # (Nt, 3) f32
    tri_e2: jax.Array  # (Nt, 3) f32
    tri_id: jax.Array  # (Nt,) i32
    node_rows: jax.Array  # (Nn, 8) f32 packed nodes (module docstring)
    tri_rows: jax.Array  # (Nt, 9) f32 packed [v0, e1, e2] slots
    leaf_size: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def num_tri_slots(self) -> int:
        return self.tri_v0.shape[0]


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 2) -> ThreadedBVH:
    """Build a threaded BVH over world-space triangles.

    Median split on the longest centroid axis (balanced depth ~= log2(T)),
    equivalent in role to the driver's PREFER_FAST_TRACE build
    (accelerationstructure.cpp:111).  Host-side NumPy; O(T log^2 T).

    Args:
      v0, v1, v2: (T, 3) float arrays, triangle vertices in world space.
      leaf_size: triangles per leaf (padded; a power of two).

    Returns a :class:`ThreadedBVH` with device arrays.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if leaf_size < 1 or leaf_size & (leaf_size - 1):
        raise ValueError(f"leaf_size must be a power of two, got {leaf_size}")

    # native C++ builder when available (accel/native.py; ~20x the NumPy
    # recursion on Sponza-class counts), identical topology contract
    from .native import bvh_build_native

    nat = bvh_build_native(v0, v1, v2, leaf_size)
    if nat is not None:
        node_min_a, node_max_a, first_a, miss_a, slots = nat
        return _finish(
            node_min_a, node_max_a, first_a, miss_a, slots, v0, v1, v2, leaf_size
        )

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    first_tri: list[int] = []
    subtree_end: list[int] = []
    tri_slots: list[int] = []  # original ids, -1 padding, leaf-contiguous

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(ids: np.ndarray) -> None:
        i = len(node_min)
        node_min.append(tmin[ids].min(axis=0))
        node_max.append(tmax[ids].max(axis=0))
        first_tri.append(-1)
        subtree_end.append(-1)
        if len(ids) <= leaf_size:
            first_tri[i] = len(tri_slots)
            tri_slots.extend(ids.tolist())
            tri_slots.extend([-1] * (leaf_size - len(ids)))
        else:
            c = centroid[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = len(ids) // 2
            part = np.argpartition(c[:, axis], mid)
            rec(ids[part[:mid]])
            rec(ids[part[mid:]])
        subtree_end[i] = len(node_min)

    rec(np.arange(T, dtype=np.int64))

    return _finish(
        np.stack(node_min),
        np.stack(node_max),
        np.asarray(first_tri, np.int32),
        np.asarray(subtree_end, np.int32),
        np.asarray(tri_slots, np.int32),
        v0, v1, v2, leaf_size,
    )


def refit_bvh(bvh: ThreadedBVH, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> ThreadedBVH:
    """Cheap AS update: keep topology, recompute AABBs + leaf triangles.

    The equivalent of the reference's AccelerationStructure::update()
    (accelerationstructure.cpp:26-32, PREFER_FAST_BUILD + allowUpdate):
    vertex positions moved but the tree structure is reused.  Leaf AABBs
    come from the new vertices through the existing slot ordering; interior
    AABBs are unioned bottom-up, one tree level at a time (children of
    interior node ``i`` are ``i+1`` and ``miss[i+1]``).  Tree quality
    degrades as geometry drifts — rebuild with build_bvh when it does,
    exactly like the reference's rebuild()/update() split.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    slots = np.asarray(bvh.tri_id)
    first = np.asarray(bvh.first_tri)
    miss = np.asarray(bvh.miss)
    k = bvh.leaf_size
    n_nodes = bvh.num_nodes

    safe = np.maximum(slots, 0)
    pad = (slots < 0)[:, None]
    w0, w1, w2 = (np.take(v, safe, axis=0) for v in (v0, v1, v2))
    tv0 = np.where(pad, np.float32(0.0), w0)
    te1 = np.where(pad, np.float32(0.0), w1 - w0)
    te2 = np.where(pad, np.float32(0.0), w2 - w0)

    smin = np.where(pad, np.inf, np.minimum(np.minimum(w0, w1), w2))
    smax = np.where(pad, -np.inf, np.maximum(np.maximum(w0, w1), w2))
    # per-leaf reduce over the k slots, unrolled (k is small)
    smin, smax = smin.reshape(-1, k, 3), smax.reshape(-1, k, 3)
    leaf_min, leaf_max = smin[:, 0], smax[:, 0]
    for j in range(1, k):
        leaf_min = np.minimum(leaf_min, smin[:, j])
        leaf_max = np.maximum(leaf_max, smax[:, j])

    # leaves seed their boxes; interior levels are collected top-down, then
    # unioned deepest first: nmin[i] = union(nmin[i+1], nmin[miss[i+1]])
    is_leaf = first >= 0
    nmin = np.full((n_nodes, 3), np.inf, np.float32)
    nmax = np.full((n_nodes, 3), -np.inf, np.float32)
    nmin[is_leaf] = leaf_min[first[is_leaf] // k]
    nmax[is_leaf] = leaf_max[first[is_leaf] // k]
    levels = []
    frontier = np.zeros(0 if is_leaf[0] else 1, np.int64)
    while frontier.size:
        levels.append(frontier)
        kids = np.concatenate([frontier + 1, miss[frontier + 1]])
        frontier = kids[~is_leaf[kids]]
    for f in reversed(levels):
        left, right = f + 1, miss[f + 1]
        nmin[f] = np.minimum(nmin[left], nmin[right])
        nmax[f] = np.maximum(nmax[left], nmax[right])

    dev = jax.numpy.asarray
    node_rows, tri_rows = _pack_rows(nmin, nmax, first, miss, slots, tv0, te1,
                                     te2, k)
    return ThreadedBVH(
        aabb_min=dev(nmin),
        aabb_max=dev(nmax),
        first_tri=bvh.first_tri,
        miss=bvh.miss,
        tri_v0=dev(tv0),
        tri_e1=dev(te1),
        tri_e2=dev(te2),
        tri_id=bvh.tri_id,
        node_rows=dev(node_rows),
        tri_rows=dev(tri_rows),
        leaf_size=k,
    )


def _pack_rows(nmin, nmax, first, miss, slots, tv0, te1, te2, k):
    """Packed node and triangle rows (module docstring)."""
    first = np.asarray(first, np.int32)
    live = (np.asarray(slots).reshape(-1, k) >= 0).sum(axis=1)
    leaf = first >= 0
    count = live[np.where(leaf, first, 0) // k]
    code = np.where(leaf, first + np.maximum(count - 1, 0), -1).astype(np.int32)
    node_rows = np.concatenate(
        [
            np.asarray(nmin, np.float32),
            np.asarray(nmax, np.float32),
            code.view(np.float32)[:, None],
            np.asarray(miss, np.int32).view(np.float32)[:, None],
        ],
        axis=1,
    )
    tri_rows = np.concatenate([tv0, te1, te2], axis=1).astype(np.float32)
    return node_rows, tri_rows


def _finish(node_min, node_max, first_tri, miss, slots, v0, v1, v2, leaf_size):
    safe = np.maximum(slots, 0)
    pad = (slots < 0)[:, None]
    tv0 = np.where(pad, 0.0, v0[safe]).astype(np.float32)
    te1 = np.where(pad, 0.0, (v1 - v0)[safe]).astype(np.float32)
    te2 = np.where(pad, 0.0, (v2 - v0)[safe]).astype(np.float32)

    dev = jax.numpy.asarray
    node_rows, tri_rows = _pack_rows(node_min, node_max, first_tri, miss,
                                     slots, tv0, te1, te2, leaf_size)
    return ThreadedBVH(
        aabb_min=dev(np.asarray(node_min, np.float32)),
        aabb_max=dev(np.asarray(node_max, np.float32)),
        first_tri=dev(np.asarray(first_tri, np.int32)),
        miss=dev(np.asarray(miss, np.int32)),
        tri_v0=dev(tv0),
        tri_e1=dev(te1),
        tri_e2=dev(te2),
        tri_id=dev(slots),
        node_rows=dev(node_rows),
        tri_rows=dev(tri_rows),
        leaf_size=leaf_size,
    )
