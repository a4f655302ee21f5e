"""Uniform grid acceleration structure, traversed with 3-D DDA.

A uniform grid traversed with 3-D DDA has *uniform* control flow — every
iteration does the same two masked things on every lane (advance one cell
/ test K triangles of the current cell), and every memory access is a flat
1-D gather.  It is not on the render path (big scenes take the per-ray BVH
walk of :mod:`vulkan_raytracer.ops.bvh_kernel`); it stays as a measured
alternative for traversal comparisons.

Build is host-side NumPy (like the reference's driver-side AS build,
accelerationstructure.cpp:85-151): triangles are binned into every cell
their AABB overlaps, stored CSR-style (cell_start, tri_ids).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """CSR cell->triangle table + grid geometry.

    ``cell_start`` has Nc+1 entries; cell c owns tri_ids[cell_start[c] :
    cell_start[c+1]].  Resolution/origin/cell sizes are static Python
    floats/ints baked into the compiled traversal.
    """

    cell_start: jax.Array  # (Nc + 1,) i32
    tri_ids: jax.Array  # (P,) i32
    res: tuple = dataclasses.field(metadata=dict(static=True))  # (rx, ry, rz)
    origin: tuple = dataclasses.field(metadata=dict(static=True))
    cell_size: tuple = dataclasses.field(metadata=dict(static=True))
    max_per_cell: int = dataclasses.field(metadata=dict(static=True))


def build_grid(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    target_tris_per_cell: float = 2.0,
    max_res: int = 256,
) -> UniformGrid:
    """Bin world-space triangles into a uniform grid.

    Resolution follows the classic heuristic: cells proportional to
    cbrt(T) scaled by the scene extent's aspect, clamped to ``max_res``.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    gmin = tmin.min(axis=0)
    gmax = tmax.max(axis=0)
    extent = np.maximum(gmax - gmin, 1e-6)
    # pad so border triangles land strictly inside
    gmin = gmin - extent * 1e-4
    gmax = gmax + extent * 1e-4
    extent = gmax - gmin

    # cells ~ T / target: coarser grids for higher target occupancy
    lam = (t / (target_tris_per_cell * float(np.prod(extent)))) ** (1.0 / 3.0)
    res = np.clip(np.ceil(extent * lam).astype(int), 1, max_res)
    cell = extent / res
    rx, ry, rz = (int(r) for r in res)

    lo = np.clip(((tmin - gmin) / cell).astype(np.int64), 0, res - 1)
    hi = np.clip(((tmax - gmin) / cell).astype(np.int64), 0, res - 1)
    span = hi - lo + 1

    # native C++ CSR binning when available
    from .native import grid_bin_native

    nat = grid_bin_native(tmin, tmax, gmin, cell, np.asarray([rx, ry, rz]))
    if nat is not None:
        start_np, ids_np, counts = nat
        return UniformGrid(
            cell_start=jnp.asarray(start_np),
            tri_ids=jnp.asarray(ids_np if ids_np.size else np.zeros(1, np.int32)),
            res=(rx, ry, rz),
            origin=(float(gmin[0]), float(gmin[1]), float(gmin[2])),
            cell_size=(float(cell[0]), float(cell[1]), float(cell[2])),
            max_per_cell=int(counts.max()) if counts.size else 0,
        )

    # expand (tri, cell) pairs; spans are small for reasonable geometry
    pairs_cell = []
    pairs_tri = []
    max_span = span.max(axis=0)
    for dx in range(int(max_span[0])):
        mx = dx < span[:, 0]
        for dy in range(int(max_span[1])):
            my = mx & (dy < span[:, 1])
            for dz in range(int(max_span[2])):
                m = my & (dz < span[:, 2])
                if not m.any():
                    continue
                ids = np.nonzero(m)[0]
                cells = (
                    (lo[ids, 0] + dx) * ry + (lo[ids, 1] + dy)
                ) * rz + (lo[ids, 2] + dz)
                pairs_cell.append(cells)
                pairs_tri.append(ids)
    cells = np.concatenate(pairs_cell)
    tris = np.concatenate(pairs_tri)
    order = np.argsort(cells, kind="stable")
    cells = cells[order]
    tris = tris[order].astype(np.int32)

    nc = rx * ry * rz
    start = np.searchsorted(cells, np.arange(nc + 1))
    counts = np.diff(start)

    return UniformGrid(
        cell_start=jnp.asarray(start.astype(np.int32)),
        tri_ids=jnp.asarray(tris),
        res=(rx, ry, rz),
        origin=(float(gmin[0]), float(gmin[1]), float(gmin[2])),
        cell_size=(float(cell[0]), float(cell[1]), float(cell[2])),
        max_per_cell=int(counts.max()) if nc else 0,
    )
