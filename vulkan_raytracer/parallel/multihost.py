"""Multi-host fleets: scene broadcast + per-host pixel sharding.

The reference is a single-process, single-GPU program (SURVEY.md §2c);
its comm layer is Vulkan queues/fences on one device.  Scaling past one
host keeps the same embarrassing pixel parallelism as
:mod:`~vulkan_raytracer.parallel.sharding` — every chip in the fleet
owns a contiguous run of the globally block-swizzled lane order — but
adds the two pieces that only exist across hosts:

* **scene broadcast** (:func:`broadcast_scene_tables`): every
  process runs the same SPMD program and builds the scene from the same
  file, but the threaded BVH builder and host FP are not guaranteed
  bit-reproducible across machines, and replicated-in-spec arrays with
  host-divergent *values* silently break collective semantics.  Host 0's
  tables are therefore broadcast to the fleet
  (``multihost_utils.broadcast_one_to_all``, over the network between
  hosts) so every card traverses the identical scene bytes.
* **cross-host image gather** (:func:`render_image_multihost`): a
  lane-sharded radiance array on a multi-host mesh is not addressable
  from any single process, so the per-band pull to host memory is a
  ``process_allgather`` (NVLink within a host, the network between
  hosts) instead
  of ``jax.device_get``.  Everything else — block swizzle, banding,
  sample-batched waves — is the exact single-host machinery, reused via
  the ``gather`` hook on :func:`~.sharding.render_image_sharded`.

Single-process (tests, the 8-virtual-device CPU mesh) both APIs reduce
to the degenerate one-host case and stay exactly equivalent to the
single-host path, which is what ``tests/test_multihost.py`` pins;
``tests/test_multihost_2proc.py`` then forms a real two-process
``jax.distributed`` fleet over localhost and proves the broadcast
repairs deliberately-diverged host tables and the cross-process gather
assembles the single-process image bit-for-bit.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh

from .sharding import render_image_sharded


def make_fleet_mesh(axis: str = "dp") -> Mesh:
    """1-D data-parallel mesh over every device in the fleet.

    ``jax.devices()`` returns the *global* device list under multi-host
    SPMD (all hosts see the same ordering), so the mesh — and therefore
    the lane assignment — is identical on every process.
    """
    return Mesh(np.asarray(jax.devices()), (axis,))


def broadcast_scene_tables(tables):
    """Replicate host 0's uploaded SceneTables onto every process.

    Pure pass-through when ``jax.process_count() == 1``.  Otherwise the
    array leaves travel host-0 → fleet; static metadata (atlas
    dims, BVH arity, instance counts) rides the pytree structure, which
    must already agree across processes (same scene file / build flags —
    asserted cheaply via the treedef string hash).
    """
    if jax.process_count() == 1:
        return tables
    import zlib

    leaves, treedef = jax.tree.flatten(tables)
    # crc32, not hash(): Python string hashing is salted per process
    multihost_utils.assert_equal(
        jax.numpy.uint32(zlib.crc32(str(treedef).encode())),
        "SceneTables static structure diverges across hosts",
    )
    out = multihost_utils.broadcast_one_to_all(leaves)
    return jax.tree.unflatten(treedef, [jax.numpy.asarray(x) for x in out])


def render_image_multihost(
    tables, camera, width, height, spp, max_depth, mesh: Mesh | None = None,
    start_sample: int = 1, tonemap: bool = True, nee_weighting: str = "reference",
):
    """Headless fleet render; same contract as ``render_image_sharded``.

    Every process returns the full image (the per-band gather is an
    allgather, so no separate host-0 scatter step is needed for IO).
    """
    if mesh is None:
        mesh = make_fleet_mesh()

    def gather(x):
        return multihost_utils.process_allgather(x, tiled=True)

    return render_image_sharded(
        tables, camera, width, height, spp, max_depth, mesh,
        start_sample=start_sample, tonemap=tonemap,
        nee_weighting=nee_weighting,
        gather=gather if jax.process_count() > 1 else None,
    )


def is_io_host() -> bool:
    """True on the process that should own file IO (image/checkpoint
    writes): host 0.  The renderer itself is SPMD-symmetric."""
    return jax.process_index() == 0
